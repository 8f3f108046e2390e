"""Polyphase DFT-filterbank channelizer + rational resampler (JAX).

Splits a wideband IQ capture into N x 25 kHz TETRA channels - the data
parallel axis of the whole pipeline (SURVEY.md section 2.10; the reference
handles exactly one VFO channel, main.cpp:75).

Design:
  * 2x-oversampled polyphase channelizer: input at fs = N*25 kHz, hop N/2
    samples per output -> each channel emits 50 kHz complex baseband.  The
    DFT across branches runs as real matmuls against the DFT basis, on
    (re, im) float32 pairs.
  * rational 18/25 polyphase resampler: 50 kHz -> 36 kHz so the demod chain
    sees its native 2 samples/symbol.

Everything is stateless slices + matmuls over a block with small tail carries,
so it composes with the sharded demod (channels axis) and the halo-exchange
time sharding of mesh.py.  Every matmul runs at Precision.HIGHEST: f32 dots
may otherwise run in TF32 on the GPU, and the CPU tests check f32 results.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.taps import nuttall

TAPS_PER_BRANCH = 48


@lru_cache(maxsize=8)
def _prototype(n_ch: int, taps_per_branch: int = TAPS_PER_BRANCH) -> np.ndarray:
    """Lowpass prototype for the filterbank: Nuttall-windowed sinc.

    The bank is 2x oversampled (50 kHz out per 25 kHz channel), so the
    passband can extend past half the channel spacing.  Cutoff 0.53/n_ch
    with 48 taps/branch keeps the TETRA RRC band edge (+-12.15 kHz) in the
    FLAT region (-0.2 dB; cutoff at half-spacing would put -6 dB right at
    the band edge and wreck the matched filter's Nyquist property) while
    still rejecting adjacent-channel energy by -71 dB at 15 kHz -- the
    demod's band-edge FLL discriminator sits at +-12.15 kHz and a leaky
    prototype biases it (the reference's 30 kHz VFO prefilter plays this
    role, main.cpp:35-36)."""
    L = n_ch * taps_per_branch
    n = np.arange(L)
    c = (L - 1) / 2.0
    cutoff = 0.53 / n_ch  # cycles/sample at the wideband rate
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, L)
    h = h / h.sum() * n_ch
    return h.astype(np.float32)


@lru_cache(maxsize=8)
def _dft_basis(n_ch: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n_ch)
    # negative exponent: channel k extracts +k*25 kHz (verified by tone test)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n_ch)
    return (W.real.astype(np.float32), W.imag.astype(np.float32))


_HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("n_ch", "frame_major"))
def _channelize_block_impl(xr, xi, n_ch: int, frame_major: bool = False):
    """(T,) wideband float pair -> (n_ch, T//(n_ch//2)) channel float pairs.

    2x oversampled: hop = n_ch//2.  Input must be padded so that
    (T - L) % hop == 0 with L = n_ch*TAPS_PER_BRANCH.

    Gather-free framing: with hop = n_ch/2, frame sample
    x[m*hop + j*n_ch + b] for branch b = d*hop + c (d in {0,1}) equals
    z[m + 2j + d, c] of the hop-reshaped input, so the polyphase fold is a
    sum of 2*TAPS_PER_BRANCH static slices of z weighted by the folded
    prototype.
    """
    hop = n_ch // 2
    L = n_ch * TAPS_PER_BRANCH
    Wr, Wi = map(jnp.asarray, _dft_basis(n_ch))
    T = xr.shape[0]
    n_out = (T - L) // hop + 1
    n_z = T // hop
    zr = xr[:n_z * hop].reshape(n_z, hop)
    zi = xi[:n_z * hop].reshape(n_z, hop)
    h2 = _prototype(n_ch).reshape(TAPS_PER_BRANCH, 2, hop)  # [j, d, c]
    acc = [[jnp.zeros((n_out, hop), xr.dtype) for _ in range(2)]
           for _ in range(2)]  # [re/im][d]
    for s in range(2 * TAPS_PER_BRANCH):
        j, d = s // 2, s % 2
        w = jnp.asarray(h2[j, d])
        acc[0][d] = acc[0][d] + zr[s:s + n_out] * w
        acc[1][d] = acc[1][d] + zi[s:s + n_out] * w
    # branch order b = d*hop + c
    fr = jnp.concatenate(acc[0], axis=-1)
    fi = jnp.concatenate(acc[1], axis=-1)
    # DFT across branches: y[m, k] = sum_b f[m, b] * exp(+j 2 pi k b / N)
    mm = partial(jnp.matmul, precision=_HI)
    yr = mm(fr, Wr.T) - mm(fi, Wi.T)          # (n_out, n_ch)
    yi = mm(fr, Wi.T) + mm(fi, Wr.T)
    # hop phase correction: branch m shifts by hop*m samples; channel k picks
    # up exp(-j 2 pi k hop m / N) = (-1)^(k m) for hop = N/2
    m = jnp.arange(n_out)
    k = jnp.arange(n_ch)
    signflip = jnp.where((m[:, None] * k[None, :]) % 2 == 1, -1.0, 1.0)
    yr = yr * signflip
    yi = yi * signflip
    if frame_major:
        return yr, yi
    return jnp.swapaxes(yr, 0, 1), jnp.swapaxes(yi, 0, 1)


def _channelize_block(xr, xi, n_ch: int):
    return _channelize_block_impl(xr, xi, n_ch)


@partial(jax.jit, static_argnames=("n_ch", "t36"))
def _front_end_block(xr, xi, hr, hi, n_ch: int, t36: int):
    """Whole wideband front-end for one block: channelize + streaming 18/25
    resample, frame-major.  xr/xi: (wide_len,) wideband rows; hr/hi:
    (RS_TAPS_PER_PHASE-1, n_ch) stream history.  Returns (rr (t36, n_ch),
    ri, hr2, hi2)."""
    yr, yi = _channelize_block_impl(xr, xi, n_ch, frame_major=True)
    return _resample_stream_block_fm(yr, yi, hr, hi, t36)


def _channelize_block_fm(xr, xi, n_ch: int):
    """Frame-major variant: returns (t50, n_ch) streams, skipping the final
    transpose so the frame-major resampler consumes them directly."""
    return _channelize_block_impl(xr, xi, n_ch, frame_major=True)


def channelize(iq: np.ndarray, n_ch: int) -> np.ndarray:
    """Host-facing: wideband complex (T,) at n_ch*25 kHz -> (n_ch, T2)
    complex at 50 kHz per channel (2x oversampled)."""
    iq = np.asarray(iq)
    xr = jnp.asarray(iq.real.astype(np.float32))
    xi = jnp.asarray(iq.imag.astype(np.float32))
    yr, yi = _channelize_block(xr, xi, n_ch)
    return np.asarray(yr) + 1j * np.asarray(yi)


# ---------------------------------------------------------------------------
# Rational polyphase resampler (50 kHz -> 36 kHz: L=18, M=25)
# ---------------------------------------------------------------------------

RS_TAPS_PER_PHASE = 24


@lru_cache(maxsize=8)
def _resamp_bank(L: int, M: int) -> np.ndarray:
    """Polyphase bank for rational L/M resampling (upsample L, filter,
    downsample M).  Cutoff at 0.48x the lower of the two Nyquists: the
    Nuttall transition then straddles the band 12.5..23.85 kHz (for 50->36)
    so the TETRA signal band stays flat while everything that would fold
    onto it is stopped.  24 taps/phase keeps the RRC band-edge droop at
    -0.09 dB with -62 dB at the first alias edge (the original 8 taps/phase
    drooped ~2 dB at the band edge and wrecked wideband EVM)."""
    total = L * RS_TAPS_PER_PHASE
    n = np.arange(total)
    c = (total - 1) / 2.0
    cutoff = 0.48 / max(L, M)  # cycles/sample in the upsampled domain
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, total)
    h = h * (L / h.sum())     # DC gain L compensates the zero-stuffing
    bank = np.zeros((L, RS_TAPS_PER_PHASE), np.float64)
    for p in range(L):
        bank[p] = h[p::L]
    return bank.astype(np.float32)


@lru_cache(maxsize=8)
def _resamp_matrix(L: int, M: int) -> tuple[np.ndarray, int, int]:
    """Banded resampling matrix for the block-matmul formulation.

    Output n = q*L + p reads input window x[q*M + off_p - pad .. q*M + off_p]
    (off_p = floor(p*M/L), pad = taps-1).  Grouping outputs into blocks of L
    and inputs into blocks of M, every output block q is a matmul of the B
    consecutive input blocks q..q+B-1 of the ZF-front-padded stream against
    one (B*M, L) matrix: y[q, p] = sum_j xpp[q*M + j] W[j, p] with
    W[ZF + off_p + t, p] = flip(bank[p])[t].  Returns (W, B, ZF)."""
    bank = _resamp_bank(L, M)
    pad = RS_TAPS_PER_PHASE - 1
    B = 1 + -(-pad // M)          # input blocks per window
    ZF = (B - 1) * M - pad        # front zero-padding that aligns windows
    W = np.zeros((B * M, L), np.float32)
    for p in range(L):
        off = (p * M) // L
        coef = bank[(p * M) % L][::-1]   # polyphase index of output q*L + p
        for t in range(RS_TAPS_PER_PHASE):
            W[ZF + off + t, p] += coef[t]
    return W, B, ZF


def _resample_matmul(xpp_r, xpp_i, Wm, n_q: int, B: int, M: int, L: int):
    """xpp: (..., (n_q+B-1)*M) padded stream pair -> (..., n_q*L) outputs."""
    shp = xpp_r.shape[:-1]
    zr = xpp_r.reshape(shp + (n_q + B - 1, M))
    zi = xpp_i.reshape(shp + (n_q + B - 1, M))
    zbr = jnp.concatenate([zr[..., k:k + n_q, :] for k in range(B)], axis=-1)
    zbi = jnp.concatenate([zi[..., k:k + n_q, :] for k in range(B)], axis=-1)
    yr = jnp.matmul(zbr, Wm, precision=_HI).reshape(shp + (n_q * L,))
    yi = jnp.matmul(zbi, Wm, precision=_HI).reshape(shp + (n_q * L,))
    return yr, yi


@partial(jax.jit, static_argnames=("n_in", "L", "M"))
def _resample_block(xr, xi, n_in: int, L: int, M: int):
    # y[n] = sum_k x[base - k] h[r + k L] with base = floor(nM/L), r = nM%L:
    # the window runs BACKWARD from base, i.e. over a (taps-1)-zero-padded
    # input with flipped per-phase coefficients.  Computed as the banded
    # matmul of _resamp_matrix (gather-free).
    Wnp, B, _ = _resamp_matrix(L, M)
    n_out = (n_in - RS_TAPS_PER_PHASE) * L // M
    n_q = -(-n_out // L)
    need = (n_q + B - 1) * M
    front = (B - 1) * M  # = ZF + pad: zero history + window alignment
    zshape = xr.shape[:-1] + (front,)
    xr = jnp.concatenate([jnp.zeros(zshape, xr.dtype), xr], axis=-1)
    xi = jnp.concatenate([jnp.zeros(zshape, xi.dtype), xi], axis=-1)
    if xr.shape[-1] < need:
        back = xr.shape[:-1] + (need - xr.shape[-1],)
        xr = jnp.concatenate([xr, jnp.zeros(back, xr.dtype)], axis=-1)
        xi = jnp.concatenate([xi, jnp.zeros(back, xi.dtype)], axis=-1)
    else:
        xr, xi = xr[..., :need], xi[..., :need]
    yr, yi = _resample_matmul(xr, xi, jnp.asarray(Wnp), n_q, B, M, L)
    return yr[..., :n_out], yi[..., :n_out]


def resample(iq: np.ndarray, L: int, M: int) -> np.ndarray:
    """(C, T) complex at fs -> (C, ~T*L/M) complex at fs*L/M."""
    iq = np.atleast_2d(np.asarray(iq))
    xr = jnp.asarray(iq.real.astype(np.float32))
    xi = jnp.asarray(iq.imag.astype(np.float32))
    yr, yi = _resample_block(xr, xi, iq.shape[1], L, M)
    return np.asarray(yr) + 1j * np.asarray(yi)


def resample_50_to_36(iq: np.ndarray) -> np.ndarray:
    return resample(iq, 18, 25)


def resample_36_to_50(iq: np.ndarray) -> np.ndarray:
    return resample(iq, 25, 18)


@lru_cache(maxsize=8)
def _resamp_super_matrix(L: int, M: int, S: int) -> np.ndarray:
    """Superblock form of _resamp_matrix for frame-major streams: S output
    blocks as one (S*L, S*M + (B-1)*M) banded matrix, so the resampler is a
    left-matmul with channels on the wide axis, where the channel-major
    form degenerates to a (.., B*M) @ (B*M, L) product with N=18 columns."""
    W, B, _ = _resamp_matrix(L, M)
    WS = np.zeros((S * L, (S + B - 1) * M), np.float32)
    for u in range(S):
        WS[u * L:(u + 1) * L, u * M:u * M + B * M] = W.T
    return WS


@partial(jax.jit, static_argnames=("t_out", "L", "M", "S"))
def _resample_stream_block_fm(xr, xi, hr, hi, t_out: int, L: int = 18,
                              M: int = 25, S: int = 32):
    """Frame-major streaming resampler: xr/xi (t_in, C) NEW input rows,
    hr/hi (RS_TAPS_PER_PHASE-1, C) carried input tail.  Same output stream
    as _resample_stream_block up to matmul summation order (channels ride
    the lane axis; time blocks ride the rows).  Returns (yr (t_out, C), yi,
    hr2, hi2)."""
    t_in = xr.shape[0]
    assert t_out * M == t_in * L, (t_out, M, t_in, L)
    pad = RS_TAPS_PER_PHASE - 1
    _, B, ZF = _resamp_matrix(L, M)
    assert B == 2, "superblock window slicing assumes B == 2"
    n_q = t_in // M
    while n_q % S:
        S //= 2
    n_super = n_q // S
    WS = jnp.asarray(_resamp_super_matrix(L, M, S))
    C = xr.shape[1]

    def run(x, h):
        zshape = (ZF,) + x.shape[1:]
        xpp = jnp.concatenate([jnp.zeros(zshape, x.dtype), h, x], axis=0)
        blocks = xpp.reshape(n_q + B - 1, M, C)
        base = blocks[:n_super * S].reshape(n_super, S * M, C)
        extra = blocks[S::S].reshape(n_super, (B - 1) * M, C)
        win = jnp.concatenate([base, extra], axis=1)  # (n_super, (S+1)M, C)
        y = jnp.einsum("ow,gwc->goc", WS, win, precision=_HI,
                       preferred_element_type=jnp.float32)
        return y.reshape(t_out, C)

    yr = run(xr, hr)
    yi = run(xi, hi)
    return yr, yi, xr[-pad:], xi[-pad:]


@partial(jax.jit, static_argnames=("t_out", "L", "M"))
def _resample_stream_block(xr, xi, hr, hi, t_out: int, L: int = 18,
                           M: int = 25):
    """Streaming polyphase resampler block with carried history.

    xr/xi: (..., t_in) NEW input samples; hr/hi: (..., RS_TAPS_PER_PHASE-1)
    tail of the previous block's inputs.  Requires t_out*M == t_in*L (the
    polyphase pattern then repeats identically every block, so static
    indices give exact sample-stream continuity).  Returns (yr, yi, hr2,
    hi2) with hr2/hi2 the new history.
    """
    t_in = xr.shape[-1]
    assert t_out * M == t_in * L, (t_out, M, t_in, L)
    pad = RS_TAPS_PER_PHASE - 1
    Wnp, B, ZF = _resamp_matrix(L, M)
    n_q = t_in // M          # t_in is a multiple of M (t_out*M == t_in*L)
    xr = jnp.concatenate([hr, xr], axis=-1)
    xi = jnp.concatenate([hi, xi], axis=-1)
    zshape = xr.shape[:-1] + (ZF,)
    xpr = jnp.concatenate([jnp.zeros(zshape, xr.dtype), xr], axis=-1)
    xpi = jnp.concatenate([jnp.zeros(zshape, xi.dtype), xi], axis=-1)
    yr, yi = _resample_matmul(xpr, xpi, jnp.asarray(Wnp), n_q, B, M, L)
    return yr, yi, xr[..., -pad:], xi[..., -pad:]
