"""Feedforward block receiver: estimate-then-apply, no per-chunk feedback.

The chunked production chain (rx/demod_fast.py) restructures the reference's
per-sample loops (complex_fd.cpp:89-151, pi4dqpsk_costas.cpp:5-21) as
chunk-rate feedback -- still a SEQUENTIAL chain of ~72 small steps per block,
which bounds throughput while the arithmetic units idle.

This module removes the feedback entirely for the bulk/offline path, the
classic feedforward block-receiver design and the natural shape for a vector
machine:

  AGC                block-mean gain (carried squelch for dead air)
  coarse CFO         one-shot z^4 estimate per block (the receiver.coarse_cfo
                     math in-graph, range +-2.25 kHz), carried
                     snap-vs-smooth, continuous-phase derotation ramp --
                     replaces the band-edge FLL: no pull-in sweep, no
                     feedback parking jitter
  RRC                stateless matched filter (overlap-save)
  timing             upsample 2 -> 4 sps (one extra half-sample interpolation
                     pass), square-law symbol-rate line per SEGMENT of
                     SEG_SYM symbols: Oerder-Meyr tau = -angle(sum |x|^2
                     e^{-j 2 pi n / 4}) / 2 pi -- a pure masked reduction
  trajectory         unwrap tau across segments (wrapped-diff cumsum -- all
                     parallel), per-symbol tau by one STATIC interpolation
                     matmul, integer-symbol alignment chosen for cross-block
                     stream continuity (no duplicated/dropped symbols)
  interpolation      one batched fractional-delay pass at the known
                     positions (same LS Horner interpolator as demod_fast)
  carrier            three-tier residual frequency (lag-1 differential
                     +-562 Hz -> lag-8 +-70 Hz -> segment-lag +-9 Hz; each
                     tier's sigma lands inside the next one's alias window)
                     then per-segment Viterbi&Viterbi phase with
                     predicted-increment unwrap and frequency-extrapolated
                     block edges
  slicing            identical quadrant/differential/remap rules, with the
                     prev-symbol difference as a global shift (parallel)

Every stage is a large batched matmul or reduction over (C, T); there is NO
sequential chain at all -- the per-segment unwraps are cumsums.  Measured
against the chunked chain: bit-exact dibits on clean signal, CRC-clean from
10 dB (chunked: 10 dB), 99.5%% vs 87%% CRC-ok at 8 dB, and first decode in
half the time (no FLL pull-in).  tests/test_demod_ff.py pins all of it.

Like demod_fast, everything on device is explicit (re, im) float32.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..core.fir import fir_stream_pair, fir_stream_pair_mm
from . import demod_fast as DF
from .demod import _DIFF_REMAP, _OMEGA, _tables

SEG_SYM = 256          # symbols per timing/phase estimation segment


class FfDemodState(NamedTuple):
    # stage 1: block AGC + one-shot z^4 CFO derotation + RRC.  No FLL: the
    # band-edge feedback loop's parking jitter (+-25 Hz block to block at
    # 10 dB) is exactly what broke the per-block frequency model; the
    # feedforward z^4 estimator (range +-2.25 kHz, the receiver.coarse_cfo
    # math in-graph) replaces both its acquisition sweep (~0.8 s) and its
    # tracking, with zero feedback jitter.
    agc_gain: jnp.ndarray
    rot_phase: jnp.ndarray    # (C,) derotation phase anchor (rad)
    rot_freq: jnp.ndarray     # (C,) derotation frequency (rad/sample)
    rrc_tail_re: jnp.ndarray
    rrc_tail_im: jnp.ndarray
    # feedforward carries.  The interpolation tail keeps 2 extra samples
    # beyond the filter history so block-head positions may reach p = -1
    # (see the continuity-aligned p_0 below) and still index the window.
    mm_tail_re: jnp.ndarray   # (C, INTERP_TAP_COUNT+1)
    mm_tail_im: jnp.ndarray
    pos: jnp.ndarray          # (C,) next-symbol position in block samples
    tau_anchor: jnp.ndarray   # (C,) last unwrapped timing (symbol fraction)
    phi_anchor: jnp.ndarray   # (C,) last unwrapped V&V phase (rad)
    cfo: jnp.ndarray          # (C,) residual-CFO estimate (rad/symbol)
    ph2: jnp.ndarray          # (C,) cumulative -pi/4 anchor (mod 2 pi)
    prev_sym: jnp.ndarray     # (C,) i32 last quadrant


def demod_init(channels: int) -> FfDemodState:
    C = channels
    zf = jnp.zeros((C,), jnp.float32)
    z2 = lambda n: jnp.zeros((C, n), jnp.float32)
    return FfDemodState(
        agc_gain=jnp.ones((C,), jnp.float32),
        rot_phase=zf, rot_freq=zf,
        rrc_tail_re=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_im=z2(P.RRC_TAP_COUNT - 1),
        mm_tail_re=z2(P.INTERP_TAP_COUNT + 1),
        mm_tail_im=z2(P.INTERP_TAP_COUNT + 1),
        pos=zf, tau_anchor=zf, phi_anchor=zf, cfo=zf, ph2=zf,
        prev_sym=jnp.zeros((C,), jnp.int32),
    )


_HALF_TAPS = None


def _half_sample_taps() -> np.ndarray:
    """mu = 0.5 row of the LS fractional-delay interpolator (demod_fast
    _bank_polys): the single extra filter that upsamples 2 -> 4 sps."""
    global _HALF_TAPS
    if _HALF_TAPS is None:
        Pb, _ = DF._bank_polys()
        mus = np.array([0.5 ** p for p in range(5, -1, -1)], np.float32)
        _HALF_TAPS = (mus @ Pb).astype(np.float32)
    return _HALF_TAPS


def _interp_matrix(n_sym: int, n_seg: int) -> np.ndarray:
    """(n_seg, n_sym) static linear-interpolation weights from segment
    centers to per-symbol values (edge-clamped)."""
    centers = (np.arange(n_seg) + 0.5) * SEG_SYM
    k = np.arange(n_sym, dtype=np.float64)
    W = np.zeros((n_seg, n_sym), np.float32)
    x = np.clip((k - centers[0]) / SEG_SYM, 0.0, n_seg - 1.0)
    i0 = np.minimum(x.astype(np.int64), n_seg - 2) if n_seg > 1 else \
        np.zeros(n_sym, np.int64)
    frac = x - i0
    W[i0, np.arange(n_sym)] = (1.0 - frac).astype(np.float32)
    if n_seg > 1:
        W[i0 + 1, np.arange(n_sym)] += frac.astype(np.float32)
    return W


_OM_MATS = {}


def _om_matrix(T: int, n_seg: int) -> np.ndarray:
    """(T, 2*n_seg) static operator: column s sums g2 over segment s with
    signs +1/-1 on even/odd samples (the real part of the symbol-rate
    line), columns n_seg+s the same with signs 0-ish pattern for the
    imaginary part (-even, +odd on the half-sample stream)."""
    key = (T, n_seg)
    if key not in _OM_MATS:
        M = np.zeros((T, 2 * n_seg), np.float32)
        L = T // n_seg
        for sgi in range(n_seg):
            rows = np.arange(sgi * L, (sgi + 1) * L)
            M[rows[0::2], sgi] = 1.0
            M[rows[1::2], sgi] = -1.0
            M[rows[0::2], n_seg + sgi] = -1.0
            M[rows[1::2], n_seg + sgi] = 1.0
        _OM_MATS[key] = M
    return _OM_MATS[key]


def _wrap(x, period):
    return x - period * jnp.floor(x / period + 0.5)


@jax.jit
def _demod_block_impl(state: FfDemodState, xr, xi):
    C, T = xr.shape
    assert T % (2 * SEG_SYM) == 0, "block must hold whole segments"
    rrc, _, _ = _tables()

    # ---- stage 1: block AGC + z^4 coarse CFO derotation + RRC ----
    # RMS amplitude: one sqrt per CHANNEL instead of one per sample (the
    # per-sample sqrt was pure transcendental load).
    # For this constant-envelope-ish signal RMS ~ mean|x| to within a
    # fraction of a dB, and the downstream chain is scale-invariant.
    amp_mean = jnp.sqrt(jnp.maximum(jnp.mean(xr * xr + xi * xi, axis=1),
                                    1e-18))
    g_new = jnp.clip(P.AGC_SETPOINT / amp_mean, 1.0 / P.AGC_MAX_GAIN,
                     P.AGC_MAX_GAIN)
    # dead-air squelch as in the chunked AGC: hold gain over signal gaps
    gain = jnp.where(amp_mean < 0.01 * P.AGC_SETPOINT, state.agc_gain, g_new)
    yr = xr * gain[:, None]
    yi = xi * gain[:, None]

    # z = x[n] conj(x[n-2]) spans one symbol at 2 sps; z^4 collapses the
    # pi/4-DQPSK modulation to a tone at angle 8 w + pi (receiver.coarse_cfo
    # proof).  One estimate per block, unambiguous to +-fs/16 = 2.25 kHz.
    # Estimated over the first quarter of the block (contiguous slice):
    # 4x less arithmetic, sigma x2 -- still far inside the 40 Hz snap
    # threshold the estimate feeds.
    Tq = max(T // 4, 512)
    qr = yr[:, :Tq]
    qi = yi[:, :Tq]
    dzr = qr[:, 2:] * qr[:, :-2] + qi[:, 2:] * qi[:, :-2]
    dzi = qi[:, 2:] * qr[:, :-2] - qr[:, 2:] * qi[:, :-2]
    # unnormalized 4th power: the coarse estimate only needs ~10 Hz
    # accuracy (the refinement tiers take it from there) and the
    # per-sample normalizing division was pure transcendental load
    z2r = dzr * dzr - dzi * dzi
    z2i = 2.0 * dzr * dzi
    z4r = jnp.mean(z2r * z2r - z2i * z2i, axis=1)
    z4i = jnp.mean(2.0 * z2r * z2i, axis=1)
    w_est = _wrap(jnp.arctan2(z4i, z4r) - np.pi, 2 * np.pi) / 8.0
    # carried frequency with snap-vs-smooth: big disagreements (acquisition,
    # retune) adopt the fresh estimate; small ones low-pass it so the
    # downstream per-block frequency tiers see a quasi-static carrier
    dw = w_est - state.rot_freq
    big = jnp.abs(dw) > (2 * np.pi * 40.0 / P.SAMPLE_RATE)
    w = jnp.where(big, w_est, state.rot_freq + 0.25 * dw)
    rot_phase = jnp.where(big, jnp.zeros_like(w), state.rot_phase)
    # derotate by e^{-j(phase + w n)} via the two-level rotator recurrence
    # (no per-sample transcendentals, small doubling passes only)
    cr, sr0 = DF.rot_ramp_outer(rot_phase, w, T)
    rotr = yr * cr + yi * sr0
    roti = yi * cr - yr * sr0
    rot_phase_next = jnp.mod(rot_phase + w * T, 2 * np.pi)
    mfr, mfi, rtr, rti = fir_stream_pair_mm(
        rotr, roti, rrc, state.rrc_tail_re, state.rrc_tail_im)

    ntaps = P.INTERP_TAP_COUNT
    er = jnp.concatenate([state.mm_tail_re, mfr], axis=1)  # (C, T+ntaps+1)
    ei = jnp.concatenate([state.mm_tail_im, mfi], axis=1)

    # ---- timing: 4 sps square-law + per-segment Oerder-Meyr ----
    # half-sample interpolants between ext[n] and ext[n+1]; x4 interleaves
    # (even = on-grid 2 sps sample, odd = half-sample point).  The half
    # taps carry the interpolator's D = ntaps//2 - 1 group delay, so the
    # on-grid stream must be delayed by the same D for coherent
    # interleaving: x4[2n] = ext[n + D], x4[2n + 1] = half(ext)[n].
    h = jnp.asarray(_half_sample_taps())
    D = ntaps // 2 - 1
    hr_ = sum(h[j] * er[:, 2 + j:2 + j + T] for j in range(ntaps))
    hi_ = sum(h[j] * ei[:, 2 + j:2 + j + T] for j in range(ntaps))
    gr = er[:, 2 + D:2 + D + T]
    gi = ei[:, 2 + D:2 + D + T]
    # |x4[n]|^2 with e^{-j pi n / 2} = 1, -j, -1, j: per 2-sps sample pair
    # (on-grid, half) the contributions are (+g2, -j h2, -g2, +j h2) for
    # even/odd sample parity -- fold into signed per-segment sums
    g2 = gr * gr + gi * gi
    h2 = hr_ * hr_ + hi_ * hi_
    n_seg = T // (2 * SEG_SYM)
    # per-segment alternating-sign sums as ONE static matmul (T, 2*n_seg)
    Mom = jnp.asarray(_om_matrix(T, n_seg))
    oms = jnp.dot(g2, Mom[:, :n_seg], preferred_element_type=jnp.float32)
    omh = jnp.dot(h2, Mom[:, n_seg:], preferred_element_type=jnp.float32)
    om_re, om_im = oms, omh
    tau = -jnp.arctan2(om_im, om_re) / (2.0 * np.pi)          # symbol frac

    # unwrap across segments from the carried anchor (parallel cumsum)
    t0 = state.tau_anchor[:, None]
    d = jnp.concatenate([_wrap(tau[:, :1] - t0, 1.0),
                         _wrap(tau[:, 1:] - tau[:, :-1], 1.0)], axis=1)
    tau_unw = t0 + jnp.cumsum(d, axis=1)                       # (C, n_seg)
    tau_last = tau_unw[:, -1]

    # ---- per-symbol positions ----
    n_sym = T // 2 + 4
    W = jnp.asarray(_interp_matrix(n_sym, n_seg))              # (n_seg, n_sym)
    tau_k = jnp.dot(tau_unw, W, preferred_element_type=jnp.float32)
    kk = jnp.arange(n_sym, dtype=jnp.float32)
    # integer-symbol alignment chosen for CONTINUITY with the carried
    # next-symbol position: |p_0 - pos| < 1 symbol-period guarantees the
    # cross-block symbol sequence has no duplicate or dropped symbol (tau
    # estimate noise is absorbed by m, never by the emitted stream)
    m = jnp.round((state.pos - 2.0 * tau_k[:, 0]) / 2.0)
    p = 2.0 * kk[None, :] + 2.0 * tau_k + 2.0 * m[:, None]     # (C, n_sym)

    # ---- batched fractional-delay interpolation at known positions ----
    # p >= -1 - eps by the continuity bound; the +2-sample tail makes
    # window index floor(p) + 2 >= 0 always, so validity is a pure
    # tail condition (prefix mask) and the pos carry below stays exact.
    #
    # GATHER-FREE: instead of gathering (C, n_sym, ntaps) windows, exploit floor(p_k) - 2k in {-2..3} (|p_0 - pos| < 1 plus
    # bounded in-block clock drift): six (shift s in {-1,0,1}) x (parity
    # b in {0,1}) window variants are plain shifted SLICES of the stream,
    # Horner-combined per symbol, then masked-selected by (s, b).
    ipos = jnp.floor(p).astype(jnp.int32)
    mu = p - jnp.floor(p)
    valid = ipos < T
    Pb = jnp.asarray(DF._bank_polys()[0])
    mu1 = mu[..., None]
    c0 = Pb[0] * mu1 + Pb[1]
    for j in range(2, 6):
        c0 = c0 * mu1 + Pb[j]                                  # (C, n_sym, 8)
    # window-offset range: +-1 symbol of block-head alignment freedom plus
    # in-block clock drift (E covers +-250 ppm over this block length; the
    # cross-block m-alignment itself tolerates drift < half a symbol per
    # block, ~200 ppm at T=4608 -- far beyond real crystals)
    E = int(np.ceil(n_sym * 2.5e-4)) if n_sym > 4096 else 0
    jmin, jmax = -2 - E, 3 + E
    # front-pad by E so drift-extended negative offsets stay indexable
    # (they only arise at k >= 1 where the true index is positive, so the
    # padding zeros are never selected)
    pad = 2 * n_sym + jmax + 2 + ntaps - (T + ntaps + 1)
    epr = jnp.pad(er, ((0, 0), (E, max(pad, 0))))
    epi = jnp.pad(ei, ((0, 0), (E, max(pad, 0))))
    j_off = ipos - 2 * jnp.arange(n_sym, dtype=jnp.int32)[None, :]
    j_off = jnp.clip(j_off, jmin, jmax)
    # split even/odd ONCE (two strided slices total); every (offset, tap)
    # window is then a CONTIGUOUS shifted slice of one of the half-rate
    # streams
    ser = epr[:, 0::2]
    sor = epr[:, 1::2]
    sei = epi[:, 0::2]
    soi = epi[:, 1::2]
    yr = jnp.zeros((C, n_sym), jnp.float32)
    yi = jnp.zeros((C, n_sym), jnp.float32)
    for joff in range(jmin, jmax + 1):
        base = joff - jmin                                     # >= 0
        acc_r = 0.0
        acc_i = 0.0
        for t in range(ntaps):
            q = base + t
            hr2 = (ser, sor)[q & 1]
            hi2 = (sei, soi)[q & 1]
            o = q >> 1
            acc_r = acc_r + c0[..., t] * jax.lax.slice_in_dim(
                hr2, o, o + n_sym, 1, axis=1)
            acc_i = acc_i + c0[..., t] * jax.lax.slice_in_dim(
                hi2, o, o + n_sym, 1, axis=1)
        mask = (j_off == joff)
        yr = jnp.where(mask, acc_r, yr)
        yi = jnp.where(mask, acc_i, yi)

    # ---- de-pi/4 (rotator-recurrence ramp anchored by carried ph2) ----
    cr, sr_neg = DF.rot_ramp(-state.ph2,
                             jnp.full_like(state.ph2, np.pi / 4.0), n_sym,
                             time_first=False)
    # rot_ramp gives cos/sin of (-ph2 + pi/4 k); we need e^{j(ph2 - pi/4 k)}
    # = conj of that
    sr_ = -sr_neg
    ypr = yr * cr - yi * sr_
    ypi = yi * cr + yr * sr_

    # ---- feedforward carrier recovery: frequency, then phase ----
    # Normalized 4th-power symbols z = y'^4 / |y'|^2 (the classic V&V
    # nonlinearity; plain y^4 overweights noise peaks at low SNR):
    # angle(z) = pi + 4 phi for the odd-multiples-of-pi/4 constellation.
    y2r = ypr * ypr - ypi * ypi
    y2i = 2.0 * ypr * ypi
    mag2 = jnp.maximum(ypr * ypr + ypi * ypi, 1e-12)
    zr = (y2r * y2r - y2i * y2i) / mag2
    zi = (2.0 * y2r * y2i) / mag2
    vm = valid.astype(jnp.float32)
    zr = zr * vm
    zi = zi * vm

    # Residual-CFO recovery in three accuracy tiers (the per-segment phase
    # steps 2 pi f S / f_sym alias past the pi/4 unwrap margin whenever the
    # flattening frequency is more than ~9 Hz off, and every aliased
    # segment corrupts SEG_SYM symbols):
    #   coarse   lag-1 differential of z: angle(sum z_{k+1} conj z_k)/4,
    #            unambiguous to +-562 Hz but noisy (~20 Hz sigma at 10 dB)
    #   carried  the previous block's refined estimate -- in steady state
    #            accurate to well under the alias margin; snapped to coarse
    #            when they disagree by > 40 Hz (acquisition / FLL jumps)
    #   refined  lag-one-SEGMENT differential of the flattened segment
    #            sums: 256x averaging before the angle, so sigma is far
    #            below the +-9 Hz window the carried estimate leaves it
    wr = (zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1]).sum(axis=1)
    wi = (zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1]).sum(axis=1)
    coarse = jnp.arctan2(wi, wr) / 4.0                       # rad/symbol
    snap = jnp.abs(coarse - state.cfo) > (2 * np.pi * 40.0 / 18000.0)
    base = jnp.where(snap, coarse, state.cfo)

    # middle rung: lag-8 symbol differential on the base-flattened stream
    # (alias window +-70 Hz covers the coarse/carried error; sigma ~2-4 Hz
    # lands the residual inside the final rung's +-9 Hz window)
    c4, s4 = DF.rot_ramp(jnp.zeros_like(base), 4.0 * base, n_sym,
                         time_first=False)
    zfr = zr * c4 + zi * s4
    zfi = zi * c4 - zr * s4
    L8 = 8
    v8r = (zfr[:, L8:] * zfr[:, :-L8] + zfi[:, L8:] * zfi[:, :-L8]).sum(1)
    v8i = (zfi[:, L8:] * zfr[:, :-L8] - zfr[:, L8:] * zfi[:, :-L8]).sum(1)
    r8 = jnp.arctan2(v8i, v8r) / (4.0 * L8)
    base = base + r8
    c8, s8 = DF.rot_ramp(jnp.zeros_like(r8), 4.0 * r8, n_sym,
                         time_first=False)
    zfr, zfi = zfr * c8 + zfi * s8, zfi * c8 - zfr * s8
    n_segp = n_sym // SEG_SYM                        # trailing <SEG ignored
    segr = zfr[:, :n_segp * SEG_SYM].reshape(C, n_segp, SEG_SYM).sum(2)
    segi = zfi[:, :n_segp * SEG_SYM].reshape(C, n_segp, SEG_SYM).sum(2)
    rr = (segr[:, 1:] * segr[:, :-1] + segi[:, 1:] * segi[:, :-1]).sum(1)
    ri = (segi[:, 1:] * segr[:, :-1] - segr[:, 1:] * segi[:, :-1]).sum(1)
    resid = jnp.arctan2(ri, rr) / (4.0 * SEG_SYM)
    domega = base + resid
    # rotate the segment sums by the refined residual at their centers
    # (the intra-segment residual ramp is < 0.4 rad in the 4x domain at
    # the 9 Hz worst case -- negligible decoherence)
    cs = (jnp.arange(n_segp, dtype=jnp.float32) + 0.5) * SEG_SYM
    angr = 4.0 * resid[:, None] * cs[None, :]
    crr = jnp.cos(angr)
    srr = jnp.sin(angr)
    seg2r = segr * crr + segi * srr
    seg2i = segi * crr - segr * srr
    phi_f = (jnp.arctan2(seg2i, seg2r) - np.pi) / 4.0
    theta = phi_f + domega[:, None] * cs[None, :]
    # predicted-increment unwrap: wrap the DEVIATION from the known ramp,
    # never the ramp itself
    half_pi = np.pi / 2.0
    p0 = state.phi_anchor[:, None]
    pred0 = domega[:, None] * cs[None, :1]
    preds = domega[:, None] * SEG_SYM
    d0 = _wrap(theta[:, :1] - p0 - pred0, half_pi) + pred0
    ds = _wrap(theta[:, 1:] - theta[:, :-1] - preds, half_pi) + preds
    theta_unw = p0 + jnp.cumsum(jnp.concatenate([d0, ds], axis=1), axis=1)
    Wp = jnp.asarray(_interp_matrix(n_sym, n_segp))
    phi_k = jnp.dot(theta_unw, Wp, preferred_element_type=jnp.float32)
    # the interpolation matrix clamps outside the segment-center span; a
    # residual frequency of even ~13 Hz ramps 0.6 rad across the 128-symbol
    # clamped head/tail, so extend the edges along the refined frequency
    edge = (jnp.minimum(kk - cs[0], 0.0)[None, :]
            + jnp.maximum(kk - cs[-1], 0.0)[None, :])
    phi_k = phi_k + domega[:, None] * edge
    # the ONE per-symbol transcendental pair of the whole chain
    cp = jnp.cos(phi_k)
    sp = jnp.sin(phi_k)
    sr = ypr * cp + ypi * sp
    si = ypi * cp - ypr * sp

    # ---- quadrant slicing + differential decode (global shift) ----
    a = (si < 0).astype(jnp.int32)
    b = (sr < 0).astype(jnp.int32)
    quad = (a << 1) | (a ^ b)
    prev = jnp.concatenate([state.prev_sym[:, None], quad[:, :-1]], axis=1)
    dibit = jnp.asarray(_DIFF_REMAP)[(quad - prev) & 3].astype(jnp.uint8)
    ideal_ang = jnp.where(a.astype(bool),
                          jnp.where(b.astype(bool), -3 * np.pi / 4,
                                    -np.pi / 4),
                          jnp.where(b.astype(bool), 3 * np.pi / 4,
                                    np.pi / 4)).astype(jnp.float32)
    dist = jnp.abs(ideal_ang - jnp.arctan2(si, sr))

    # ---- state carries ----
    n_valid = jnp.sum(valid, axis=1)
    last_q = jnp.where(n_valid > 0,
                       jnp.take_along_axis(
                           quad, (n_valid - 1).clip(0)[:, None], axis=1)[:, 0],
                       state.prev_sym)
    pos_next = jnp.take_along_axis(
        p, jnp.minimum(n_valid, n_sym - 1)[:, None], axis=1)[:, 0] - T
    ph2_next = jnp.mod(
        state.ph2 - (np.pi / 4.0) * n_valid.astype(jnp.float32), 2 * np.pi)
    # carrier-phase anchor at the next block's first symbol (extrapolate
    # the last segment's total phase by the frequency estimate)
    phi_end = theta_unw[:, -1] + domega * (
        n_valid.astype(jnp.float32) - cs[-1])

    new_state = FfDemodState(
        agc_gain=gain, rot_phase=rot_phase_next, rot_freq=w,
        rrc_tail_re=rtr, rrc_tail_im=rti,
        mm_tail_re=er[:, T:], mm_tail_im=ei[:, T:],  # last ntaps+1 columns
        pos=pos_next, tau_anchor=_wrap(tau_last, 1.0),
        phi_anchor=_wrap(phi_end, 2 * np.pi), cfo=domega,
        ph2=ph2_next, prev_sym=last_q)
    outs = dict(sym_re=sr, sym_im=si, dibits=dibit, valid=valid, dist=dist,
                fll_freq=w, agc_gain=gain)
    return new_state, outs


def demod_block(state: FfDemodState, iq: np.ndarray):
    """Feedforward demod of one (C, T) complex block; T must be a multiple
    of 2*SEG_SYM (and of demod_fast.K_SAMP for the shared stage 1)."""
    iq = np.atleast_2d(iq)
    xr = jnp.asarray(np.ascontiguousarray(iq.real, dtype=np.float32))
    xi = jnp.asarray(np.ascontiguousarray(iq.imag, dtype=np.float32))
    return _demod_block_impl(state, xr, xi)


@jax.jit
def _demod_scan_impl(state, xr_k, xi_k):
    def body(st, xs):
        return _demod_block_impl(st, xs[0], xs[1])
    return jax.lax.scan(body, state, (xr_k, xi_k))


def demod_blocks(state: FfDemodState, iq: np.ndarray):
    """Bulk demod of (k, C, T) stacked blocks in one device call."""
    iq = np.asarray(iq)
    xr = jnp.asarray(np.ascontiguousarray(iq.real, dtype=np.float32))
    xi = jnp.asarray(np.ascontiguousarray(iq.imag, dtype=np.float32))
    return _demod_scan_impl(state, xr, xi)
