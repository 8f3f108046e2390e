"""Production demod chain: chunked-update feedback loops (JAX).

The reference runs every control loop sample-by-sample (fll.cpp:135-149,
complex_fd.cpp:89-151).  That maps poorly onto a vector machine: a 36 kS/s
stream costs 36000 sequential scan steps per second per block.  This variant
restructures each loop as a *chunked* block-scan (SURVEY.md section 7
"block-scans with carried state"):

  * AGC + FLL: loop state (gain, phase, freq) is frozen across a K-sample
    chunk; the chunk is rotated by the frozen phase ramp, both band-edge
    filters run as stateless convolutions over the chunk, and the per-sample
    error sum drives ONE loop update per chunk.  Equivalent to lowering the
    update rate by K while keeping the same aggregate gain.
  * Timing + Costas: symbol positions inside a chunk extrapolate from the
    frozen (position, omega) pair, all Ks interpolants compute in one gather
    + dot against the polyphase bank (plus a precomputed derivative bank for
    the ML error), and the summed errors drive one update per chunk.

Convergence transients differ slightly from the per-sample loops (coarser
update granularity); the acceptance criterion is unchanged burst bits at
operating SNR (>= 20 dB), which tests/test_demod_fast.py checks end-to-end
against the exact-mode chain.  All arithmetic is float32 (re, im) pairs - no
complex dtype on device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..core.fir import fir_stream_pair
from .demod import (_COSTAS_FREQ_LIM, _FLL_FREQ_LIM,
                    _COSTAS_ALPHA as _COSTAS_ALPHA_REF,
                    _COSTAS_BETA as _COSTAS_BETA_REF,
                    _FLL_BETA as _FLL_BETA_REF,
                    _MM_MU_GAIN as _MM_MU_GAIN_REF,
                    _MM_OMEGA_GAIN as _MM_OMEGA_GAIN_REF,
                    _OMEGA, _OMEGA_MAX, _OMEGA_MIN, _DIFF_REMAP, _tables)

K_SAMP = 64    # AGC/FLL chunk length (samples)
K_SYM = 32     # timing/Costas chunk length (symbols)

# Chunked loops aggregate the per-sample error over a chunk, so the gain
# per SAMPLE is K-independent -- but the update latency grows with K, which
# shrinks the phase margin.  Scaling every loop gain by (K_ref / K) keeps
# the product (bandwidth x update latency) at its tuned value as the chunk
# size changes, so larger chunks (fewer sequential kernel steps: the
# throughput bound) trade loop bandwidth instead of stability.
_K_SAMP_REF = 64       # chunk sizes the gains below were tuned at
_K_SYM_REF = 32
# sqrt scaling: full (K_ref/K) halves the pull-in rate and misses the
# acquisition window at 600 Hz CFO; unscaled doubles the idle-channel
# jitter.  1/sqrt(K/K_ref) keeps the aggregated-error noise bandwidth
# constant while pull-in only slows ~1.4x.
_FLL_BETA = _FLL_BETA_REF * float(np.sqrt(_K_SAMP_REF / K_SAMP))
# Costas at half the reference per-symbol gain: the dominant noise input to
# the chunked Costas is timing-jitter-induced symbol noise (not thermal), so
# once the timing loop below is quieted, halving the Costas bandwidth halves
# the tracked jitter with no measured acquisition cost (scripts/tune_loops.py
# grid: op-point 0.055 -> 0.042 rad, clean floor 0.018 -> 0.009).
_COSTAS_GAIN_SCALE = 0.5 * (_K_SYM_REF / K_SYM)
_COSTAS_ALPHA = _COSTAS_ALPHA_REF * _COSTAS_GAIN_SCALE
_COSTAS_BETA = _COSTAS_BETA_REF * _COSTAS_GAIN_SCALE

# Chunked timing-loop bandwidth: with the natural-scale S-curve restoring
# the designed damping, the reference's per-sample gains scale down as
# mu x 1/8, omega x 1/16 -- i.e. halving the earlier 1/4 flat scale on the
# first-order term and QUARTERING the second-order term.  Scaling both
# gains by the same factor s drops the loop damping by sqrt(s) (zeta ~
# Kp/sqrt(Ki)): the earlier flat 1/4 left the loop underdamped, so its
# detector self-noise rang instead of averaging out, and pushing the flat
# scale lower made quality WORSE (0.5 -> 0.25 flat: clean 0.020 -> 0.027).
# Keeping omega ~ mu^2 preserves damping while narrowing bandwidth:
# measured floors (scripts/tune_loops.py) clean 0.023 -> 0.009, half-sample
# mu 0.017 -> 0.013, 100 ppm clock 0.030 -> 0.018, 20 dB + 600 Hz operating
# point 0.056 -> 0.042 rad mean |phase err| -- the clean floor now matches
# the per-sample reference tuning (~0.009) while a 100 ppm clock still
# tracks with margin.
_MM_MU_GAIN = _MM_MU_GAIN_REF * 0.125 * (_K_SYM_REF / K_SYM)
_MM_OMEGA_GAIN = _MM_OMEGA_GAIN_REF * 0.0625 * (_K_SYM_REF / K_SYM) ** 2

# Chunked decision-directed loops admit false equilibria when the phase can
# sweep a full pi/2 decision period within one chunk (the aggregated error
# then integrates to zero over the S-curve).  Clamp the Costas frequency so
# the worst-case per-chunk excursion stays well under pi/2; post-FLL carrier
# residuals are far smaller than this anyway.
_COSTAS_FREQ_LIM_CHUNKED = np.pi / (4.2 * K_SYM)

# Pair-mode (2 chunks per stage-2 step, see _mm_costas_chunked) gain
# scaling vs the K_SYM=32 tuning above.  Measured grid at the 20 dB +
# 600 Hz operating point and on a clean channel (mean |sin(phase err)|,
# steady state; unpaired reads 0.080 / 0.061):
#
#   mu/om ca/cb     op      clean
#   1/1   1/1       0.430   0.419   (full gains at doubled latency:
#   .7/.5 1/1       0.424   0.425    the CARRIER loop goes unstable)
#   .7/.5 .7/.5     0.081   0.060   (sqrt law everywhere: parity)
#   .5/.25 .7/.5    0.056   0.052   (timing at the full K law, Costas at
#                                    sqrt: BETTER than unpaired -- the
#                                    narrower timing loop tracks less
#                                    detector self-noise, exactly as the
#                                    round-2 tuning grid found)
#
# So: timing mu ~ 1/K, omega ~ 1/K^2 (damping-preserving narrow-down);
# Costas alpha ~ 1/sqrt(K) with beta ~ alpha^2 (the FLL's own sqrt
# compromise -- flat-K alpha halves pull-in margin, full alpha rings);
# clamp ~ 1/K (the pi/2-sweep bound).
_PAIR_MU = 0.5
_PAIR_OM = 0.25
_PAIR_CA = 0.7
_PAIR_CB = 0.5
_PAIR_CLIM = 0.5

# Stage-1 (AGC/FLL) pairing: fresh per-half measurements, sequential per-64
# updates (quality gates all pass).  Off by default: it has not been shown
# to pay on any hardware, and stage 1 is elementwise-bound (rot ramp, amp,
# fastamp per sample), which pairing does not reduce.
PAIR_STAGE1 = False

# Band-edge error-tap DECIMATION (the stage-1 elementwise lever): only the
# per-chunk SUM of the band-edge error drives the FLL (fll.cpp:135-149
# integrates per sample; the chunked loop aggregates anyway), and adjacent
# band-edge outputs are correlated over the 65-tap filter span, so
# evaluating the error filters at every D-th sample keeps nearly the full
# information content of the sum while cutting 4/5 of stage 1's stacked
# matmul rows to 4K/D and the per-tap |.|/fastamp work by D.  The
# decimated sum is scaled by D so the aggregate loop gain stays at its
# tuned value (same S-curve expectation).  Measured (quality_probe, r4):
# decimation IMPROVES the full-band quality grid -- D=4: clean 0.0105 ->
# 0.0040, mu_half 0.0179 -> 0.0093, ppm100 0.0192 -> 0.0099, op 0.0427
# -> 0.0429 rad -- the decimated taps sum less correlated band-edge
# pattern noise per update, so the FLL freq jitter the Costas must track
# is lower.  D must divide K_SAMP.  1 = reference behavior.
#
# WHY D=2 AND NOT MORE -- two measured decimation pathologies (r4):
#   * TAP PARITY: at 2 samples/symbol the band-edge error statistic is
#     cyclostationary with period 2; a uniform even-stride comb samples
#     ONE intra-symbol phase only, and channels whose timing lands
#     adversely see a biased S-curve (the channelized soak's worst
#     channel went ~0 -> 37% CRC failures).  _fll_tap_offsets therefore
#     alternates the comb +-(j&1) so both parities contribute equally.
#   * ALIASING on band-limited input: even parity-balanced, D=4 folds
#     the error process at fs/4 (9 kHz) into DC; on CHANNELIZED 25 kHz
#     channels the folded component is CFO/timing-dependent and one
#     8-channel test carrier went from 0 to ~200 steady-state CRC
#     failures (test_superblock_wideband_matches_per_cycle) while the
#     full-band quality grid stayed clean -- full-band probes do NOT
#     cover this.  D=2 folds at fs/2, outside the error bandwidth:
#     the same carrier reads (267 ok, 0 fail), better than D=1's
#     (54, 0) late lock.
# Env-overridable (TETRA_FLL_DECIM / TETRA_AGC_RMS) for A/B measurement.
import os as _os

FLL_DECIM = int(_os.environ.get("TETRA_FLL_DECIM", "2"))
# Fail fast on unsupported D in BOTH chains (ADVICE r4): an odd D > 1 turns
# the +-(j&1) comb all-even (the documented parity bias: 37% CRC failures),
# and D must divide K_SAMP or the per-chunk error sums misalign.  The knob
# is a PROCESS-START env var: the chain traces it into jitted programs on
# first use, so runtime mutation after the first demod call is not
# supported (set TETRA_FLL_DECIM before importing).
if not (FLL_DECIM == 1 or (FLL_DECIM % 2 == 0
                            and K_SAMP % FLL_DECIM == 0)):
    # a raise, not assert: must survive python -O (the failure mode is a
    # silent 37%-CRC-failure parity bias)
    raise ValueError(
        f"TETRA_FLL_DECIM={FLL_DECIM}: need 1 or an even divisor of "
        f"{K_SAMP}")

# AGC amplitude estimator: the EXACT full-chunk mean |y| stays.  Three
# cheaper estimators were built and MEASURED failing (r4) -- the AGC
# level feeds every loop's error scale, so its estimator noise is a
# loop-gain dither the chain is sensitive to:
#   * max+0.4min fastamp: angle-dependent bias noise; BER 1.9% at the
#     20 dB + 600 Hz operating point.
#   * sub-windowing |.| (16 of 64 samples): unbiased, but the 4x
#     estimator variance rides the nearly-unsmoothed r_eff loop as
#     chunk-rate gain AM that stretches the acquisition transient ~8x
#     (errors to bit ~2600 vs ~320 at 25 dB + 200 Hz).
#   * kappa*RMS (one sqrt/chunk from mean |y|^2, kappa = E|y|/RMS =
#     0.9547 of the clean TETRA pulse): quadruples the CLEAN dist floor
#     (0.0105 -> 0.0423 rad) -- the |y|^2 pattern noise (envelope
#     kurtosis) is worse than mean-|.|'s.  Kept behind TETRA_AGC_RMS=1
#     with this evidence.
AGC_RMS = _os.environ.get("TETRA_AGC_RMS", "0") == "1"
_AMP_KAPPA = 0.9547


class FastDemodState(NamedTuple):
    agc_gain: jnp.ndarray     # (C,)
    fll_phase: jnp.ndarray    # (C,)
    fll_freq: jnp.ndarray     # (C,)
    fll_hist_re: jnp.ndarray  # (C, 64) pre-rotation input history
    fll_hist_im: jnp.ndarray
    rrc_tail_re: jnp.ndarray  # (C, 64)
    rrc_tail_im: jnp.ndarray
    mm_tail_re: jnp.ndarray   # (C, 7)
    mm_tail_im: jnp.ndarray
    mm_pos: jnp.ndarray       # (C,) f32 fractional sample position in block
    mm_omega: jnp.ndarray     # (C,) f32 samples/symbol
    cos_phase: jnp.ndarray    # (C,)
    cos_freq: jnp.ndarray     # (C,)
    cos_ph2: jnp.ndarray      # (C,) cumulative -pi/4 (mod 2 pi)
    prev_sym: jnp.ndarray     # (C,) i32


def demod_init(channels: int) -> FastDemodState:
    C = channels
    zf = jnp.zeros((C,), jnp.float32)
    z2 = lambda n: jnp.zeros((C, n), jnp.float32)
    return FastDemodState(
        agc_gain=jnp.ones((C,), jnp.float32),
        fll_phase=zf, fll_freq=zf,
        fll_hist_re=z2(P.RRC_TAP_COUNT - 1), fll_hist_im=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_re=z2(P.RRC_TAP_COUNT - 1), rrc_tail_im=z2(P.RRC_TAP_COUNT - 1),
        mm_tail_re=z2(P.INTERP_TAP_COUNT - 1), mm_tail_im=z2(P.INTERP_TAP_COUNT - 1),
        mm_pos=zf, mm_omega=jnp.full((C,), _OMEGA, jnp.float32),
        cos_phase=zf, cos_freq=zf, cos_ph2=zf,
        prev_sym=jnp.zeros((C,), jnp.int32),
    )


_DBANK = None
_POLY = None


def _bank_polys():
    """Degree-5 Horner-polynomial fractional-delay interpolator + derivative.

    The taps are least-squares designed per mu against the ideal band-limited
    delay e^{-j2pi f(D+mu)} over |f| <= 0.36 cycles/sample (the TETRA signal
    occupies +-0.3375 at 2 sps), then fitted as degree-5 polynomials in mu
    (max fit error 4e-5).  This replaces the reference's 128x8
    Nuttall-windowed-sinc bank (complex_fd.cpp:153-158, kept verbatim in the
    per-sample parity chain): the windowed-sinc bank has a ~4% gain droop
    and a delay bias at fractional mu whose biased timing S-curve makes the
    CHUNKED loop slip one symbol every few hundred -- each slip steps the
    pi/4 derotation parity and masquerades as a ~13 Hz carrier rotation.
    The LS taps are flat (-43 dB worst-case interpolation error vs -25 dB)
    and bias-free at every mu.  Returns (Pb, Pd), shape (6, ntaps),
    highest power first; the derivative taps target d/dmu of the same ideal
    response (the timing-error dfdt of complex_fd.cpp:104-125)."""
    global _POLY
    if _POLY is None:
        ntaps = P.INTERP_TAP_COUNT
        D = ntaps // 2 - 1
        fgrid = np.linspace(-0.36, 0.36, 481)
        E = np.exp(-2j * np.pi * np.outer(fgrid, np.arange(ntaps)))
        A = np.vstack([E.real, E.imag])
        mus = np.linspace(0.0, 1.0, 129)
        C = np.empty((len(mus), ntaps))
        Cd = np.empty((len(mus), ntaps))
        for i, mu in enumerate(mus):
            tgt = np.exp(-2j * np.pi * fgrid * (D + mu))
            C[i], *_ = np.linalg.lstsq(
                A, np.concatenate([tgt.real, tgt.imag]), rcond=None)
            # derivative at natural d/dmu scale (see _mm_costas_chunked:
            # the error normalization that keeps the clock loop damped)
            tgtd = -2j * np.pi * fgrid * tgt
            Cd[i], *_ = np.linalg.lstsq(
                A, np.concatenate([tgtd.real, tgtd.imag]), rcond=None)
        V = np.vander(mus, 6)
        Pb, *_ = np.linalg.lstsq(V, C, rcond=None)
        Pd, *_ = np.linalg.lstsq(V, Cd, rcond=None)
        _POLY = (Pb.astype(np.float32), Pd.astype(np.float32))
    return _POLY


def _deriv_bank():
    """Central-difference derivative of the interpolator bank w.r.t. phase
    index (edges one-sided), matching the adjacent-phase dfdt of
    complex_fd.cpp:104-125 in a single dot product."""
    global _DBANK
    if _DBANK is None:
        _, _, bank = _tables()
        d = np.empty_like(bank)
        d[1:-1] = (bank[2:] - bank[:-2]) * 0.5
        d[0] = bank[1] - bank[0]
        d[-1] = bank[-1] - bank[-2]
        _DBANK = d
    return _DBANK


def n_chunks_for(block_len: int) -> int:
    """Stage-2 chunk count for a block: enough K_SYM-symbol chunks to cover
    the block at the slowest admissible clock, rounded UP TO EVEN so the
    chunk-PAIRED stage 2 engages (pairing halves the sequential chain, the
    demod throughput bound; an all-invalid trailing chunk costs ~1.3%
    compute).  Odd counts remain supported (unpaired) for legacy callers."""
    n = int(np.ceil(block_len / (K_SYM * _OMEGA_MIN))) + 1
    return n + (n & 1)


def max_symbols(block_len: int) -> int:
    return n_chunks_for(block_len) * K_SYM


# ---------------------------------------------------------------------------
# Stage 1: chunked AGC + FLL
# ---------------------------------------------------------------------------


def _fll_tap_offsets(KG: int) -> np.ndarray:
    """Parity-balanced decimated band-edge tap positions in a KG-sample
    group (see the FLL_DECIM note: even-stride combs at 2 sps sample one
    cyclostationary phase only and bias the FLL on half the timing
    offsets)."""
    D = FLL_DECIM
    if D == 1:
        return np.arange(KG)
    j = np.arange(KG // D)
    return D * j + D // 2 - 1 + (j & 1)


def _band_matrices(be, K: int = K_SAMP):
    """Banded convolution matrices H (M+K-1, K) with
    y[k] = sum_j ext[j] H[j, k] = sum_m h[m] ext[k+M-1-m]: expresses the
    in-chunk band-edge filtering as dense matmuls."""
    M = P.RRC_TAP_COUNT
    rows = M + K - 1
    mats = []
    for h in be:
        H = np.zeros((rows, K), np.float32)
        for k in range(K):
            H[k:k + M, k] = h[::-1]
        mats.append(H)
    return mats


def rot_ramp(phase, freq, K: int, time_first: bool):
    """(cos, sin) of ph_n = phase + freq*n for n = 0..K-1 without per-sample
    transcendentals.

    The naive ramp costs 2 transcendentals per SAMPLE.  Instead:
    2 transcendental pairs per CHUNK (e^{j phase}, e^{j freq}) and the
    powers e^{j freq n} via binary decomposition of n -- log2(K) full-width
    complex multiply/select passes, identical shapes every pass.  For K a
    multiple of 64 the doubling runs TWO-LEVEL: e^{j(phase + freq*8 q)}
    over the 8 majors and e^{j freq r} over the 8 minors by small
    doublings, then one repeat/tile complex multiply assembles the ramp --
    the full-width doubling passes drop from log2(K) to 1, cutting stage
    1's dominant elementwise term (the fp32 error stays ~1e-6: <= 3+3 chained
    unit-magnitude multiplies plus one product, re-anchored per chunk by
    the exact e^{j phase}).

    phase/freq: (C,).  Returns (K, C) pairs if time_first else (C, K).
    """
    chunk = 8
    if K % (chunk * chunk) == 0:
        Q = K // chunk
        cM, sM = rot_ramp(phase, freq * chunk, Q, time_first)
        cm, sm = rot_ramp(jnp.zeros_like(phase), freq, chunk, time_first)
        if time_first:
            cMr = jnp.repeat(cM, chunk, axis=0)          # (K, C)
            sMr = jnp.repeat(sM, chunk, axis=0)
            cmr = jnp.tile(cm, (Q, 1))
            smr = jnp.tile(sm, (Q, 1))
        else:
            cMr = jnp.repeat(cM, chunk, axis=1)          # (C, K)
            sMr = jnp.repeat(sM, chunk, axis=1)
            cmr = jnp.tile(cm, (1, Q))
            smr = jnp.tile(sm, (1, Q))
        return cMr * cmr - sMr * smr, sMr * cmr + cMr * smr
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    wc = jnp.cos(freq)
    ws = jnp.sin(freq)
    # bit masks from an in-graph iota
    if time_first:
        c = jnp.broadcast_to(c[None, :], (K,) + c.shape)
        s = jnp.broadcast_to(s[None, :], (K,) + s.shape)
        ns = jax.lax.broadcasted_iota(jnp.int32, (K, 1), 0)
        wsel = lambda w: w[None, :]
    else:
        c = jnp.broadcast_to(c[:, None], c.shape + (K,))
        s = jnp.broadcast_to(s[:, None], s.shape + (K,))
        ns = jax.lax.broadcasted_iota(jnp.int32, (1, K), 1)
        wsel = lambda w: w[:, None]
    for b in range(max(1, (K - 1).bit_length())):
        m = ((ns >> b) & 1) == 1
        wcb, wsb = wsel(wc), wsel(ws)
        cn = c * wcb - s * wsb
        sn = s * wcb + c * wsb
        c = jnp.where(m, cn, c)
        s = jnp.where(m, sn, s)
        wc, ws = wc * wc - ws * ws, 2.0 * wc * ws
    return c, s


def rot_ramp_outer(phase, freq, K: int, chunk: int = 64):
    """rot_ramp via a two-level outer product: e^{j(phase + freq n)} with
    n = chunk q + r as (major ramp over q) x (minor ramp over r).

    The log-depth doubling of rot_ramp runs ~log2(K) full-width passes,
    a large share of the feedforward chain at K=4608.  Here the
    doubling runs only on (C, K/chunk) and (C, chunk) arrays and one
    broadcast complex multiply assembles the full ramp.  Returns (C, K)
    cos/sin."""
    assert K % chunk == 0
    Q = K // chunk
    cM, sM = rot_ramp(phase, freq * chunk, Q, time_first=False)   # (C, Q)
    cm, sm = rot_ramp(jnp.zeros_like(phase), freq, chunk,
                      time_first=False)                           # (C, chunk)
    c = cM[:, :, None] * cm[:, None, :] - sM[:, :, None] * sm[:, None, :]
    s = sM[:, :, None] * cm[:, None, :] + cM[:, :, None] * sm[:, None, :]
    C = phase.shape[0]
    return c.reshape(C, K), s.reshape(C, K)


def _agc_fll_chunked(xr, xi, gain, phase, freq, hre, him, be,
                     pair: bool | None = None):
    """Chunked AGC/FLL: loop updates per K_SAMP-sample chunk.

    pair (default: PAIR_STAGE1 and T a multiple of 2*K_SAMP): apply
    gain/rotation FROZEN over a
    2*K_SAMP group, run the banded filters over the whole group (ONE
    (C, M-1+2K) @ (M-1+2K, 2K) matmul set: (M-1+K)/K -> (M-1+2K)/2K
    ops per sample-tap, a 25% matmul-work cut at M-1 == K), then apply TWO
    sequential loop updates from the per-half error/amplitude sums.
    Unlike stage-2 pairing the half measurements are FRESH (the filters
    see every sample); only the applied gain/rotation of the second half
    is one update stale -- dynamics stay the tuned K_SAMP=64 loops'
    (a single update per 128 was measured failing 600 Hz pull-in).
    Halves the sequential chain, the post-stage-2-pairing demod bound."""
    C, T = xr.shape
    assert T % K_SAMP == 0
    if pair is None:
        pair = PAIR_STAGE1 and (T % (2 * K_SAMP) == 0)
    H_g = 2 if pair else 1
    KG = H_g * K_SAMP
    n_steps = T // KG
    M = P.RRC_TAP_COUNT
    D = FLL_DECIM
    assert K_SAMP % D == 0
    npd = K_SAMP // D                     # error taps per K_SAMP chunk
    offs = _fll_tap_offsets(KG)           # parity-balanced tap positions
    Hlo_r, Hlo_i, Hhi_r, Hhi_i = [jnp.asarray(H[:, offs])
                                  for H in _band_matrices(be, KG)]

    xr_c = jnp.swapaxes(xr.reshape(C, n_steps, KG), 0, 1)
    xi_c = jnp.swapaxes(xi.reshape(C, n_steps, KG), 0, 1)

    def step(carry, xc):
        gain, phase, freq, hre, him = carry
        cr, ci = xc                               # (C, KG)
        yr, yi = cr * gain[:, None], ci * gain[:, None]
        # multiplicative (log-domain) chunk update.  Naively summing K raw
        # per-sample steps (rate * sum(setpoint - amp)) is an ADDITIVE step
        # whose size does not scale with the gain: whenever the converged
        # gain is far from 1 (strong or weak inputs), |dg| ~ gain and the
        # loop falls into a +-6 dB/chunk limit cycle -- chunk-rate AM that
        # wrecks the constellation (dist 0.5 on a clean signal at 16x
        # amplitude).  The per-sample reference loop (fast_agc.h) never
        # sees this because its error shrinks within the chunk as it
        # adapts.  A geometric step gain *= (setpoint/amp)^r is
        # scale-invariant: first-order in log domain, same equilibrium
        # (mean amp == setpoint), converges from any input level in a
        # couple of chunks with no cycling.  r matches the aggregate
        # per-sample convergence 1-(1-rate)^K.
        # frozen phase ramp across the group (rotator recurrence: no
        # per-sample transcendentals, see rot_ramp)
        c, s = rot_ramp(phase, freq, KG, time_first=False)
        rr = yr * c + yi * s
        ri = yi * c - yr * s
        # band-edge filters over [history | group] as banded matmuls:
        # (C, M-1+KG) @ (M-1+KG, KG), no gathers.  HIGHEST: f32 dots may
        # otherwise run in TF32 on the GPU, and the CPU tests check f32
        er = jnp.concatenate([hre, rr], axis=1)   # (C, M-1+KG)
        ei = jnp.concatenate([him, ri], axis=1)
        mm = lambda x, H: jnp.dot(x, H, precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
        lo_re = mm(er, Hlo_r) - mm(ei, Hlo_i)
        lo_im = mm(er, Hlo_i) + mm(ei, Hlo_r)
        hi_re = mm(er, Hhi_r) - mm(ei, Hhi_i)
        hi_im = mm(er, Hhi_i) + mm(ei, Hhi_r)
        fa = lambda re, im: jnp.maximum(jnp.abs(re), jnp.abs(im)) \
            + 0.4 * jnp.minimum(jnp.abs(re), jnp.abs(im))
        err = fa(hi_re, hi_im) - fa(lo_re, lo_im)          # (C, KG//D)
        # per-K_SAMP sequential updates from FRESH per-half sums (the
        # tuned K_SAMP dynamics; only the APPLIED gain/rotation above is
        # one update stale for the second half).  The decimated error sum
        # is scaled by D (same aggregate gain as the full sum); the AGC
        # amplitude stays the exact full-chunk mean |.| (every cheaper
        # estimator measured failing -- see the AGC_RMS note above).
        ramp_freq = freq               # the frozen freq the ramp applied
        r_eff = 1.0 - (1.0 - P.AGC_RATE) ** K_SAMP
        beta_d = _FLL_BETA * D
        if AGC_RMS:
            pw = yr * yr + yi * yi     # |y|^2, (C, KG)
        for h in range(H_g):
            sa = slice(h * K_SAMP, (h + 1) * K_SAMP)
            if AGC_RMS:
                amp_mean = _AMP_KAPPA * jnp.sqrt(
                    jnp.mean(pw[:, sa], axis=1))
            else:
                awr, awi = yr[:, sa], yi[:, sa]
                amp_mean = jnp.mean(jnp.sqrt(awr * awr + awi * awi), axis=1)
            amp_mean = jnp.maximum(amp_mean, 1e-9)
            ratio = jnp.clip(P.AGC_SETPOINT / amp_mean, 0.25, 4.0)
            # dead-air squelch: when the chunk is essentially empty
            # (signal gap), hold the gain instead of ramping to
            # AGC_MAX_GAIN -- a maxed-out gain turns the first chunks
            # after signal return into a ~1e7x overload that slams the
            # FLL to its rail and stalls re-acquisition for seconds
            ratio = jnp.where(amp_mean < 0.01 * P.AGC_SETPOINT, 1.0, ratio)
            gain = jnp.minimum(gain * ratio ** r_eff, P.AGC_MAX_GAIN)
            err_sum = jnp.sum(err[:, h * npd:(h + 1) * npd], axis=1)
            freq = jnp.clip(freq + beta_d * err_sum,
                            -_FLL_FREQ_LIM, _FLL_FREQ_LIM)
        # carried phase = the APPLIED rotation's end (continuity of the
        # rotated stream into the next group; uses the ramp's frozen freq)
        new_phase = phase + ramp_freq * KG
        new_phase = new_phase - 2 * np.pi * jnp.floor(
            (new_phase + np.pi) / (2 * np.pi))
        return ((gain, new_phase, freq, er[:, -(M - 1):],
                 ei[:, -(M - 1):]), (rr, ri))

    (gain, phase, freq, hre, him), (outr, outi) = jax.lax.scan(
        step, (gain, phase, freq, hre, him), (xr_c, xi_c))
    outr = jnp.swapaxes(outr, 0, 1).reshape(C, T)
    outi = jnp.swapaxes(outi, 0, 1).reshape(C, T)
    return outr, outi, gain, phase, freq, hre, him


# ---------------------------------------------------------------------------
# Stage 2: chunked timing recovery + Costas + symbol extraction
# ---------------------------------------------------------------------------


def _mm_costas_chunked(yr, yi, tail_re, tail_im, pos, omega,
                       cphase, cfreq, ph2, prev_sym, n_chunks: int,
                       pair: bool | None = None):
    """pair (default: auto = n_chunks even) processes TWO K_SYM chunks per
    scan step: symbol positions and
    the Costas derotation ramp for the
    whole 2*K_SYM group extrapolate from the state FROZEN at the group
    start (cross-chunk position prediction), and ONE loop update per group
    applies at the module's documented K-scaling law for chunk size 64
    (mu x 1/2, omega x 1/4, Costas x 1/2, clamp x 1/2) -- the loops run as
    tuned-for-K=64 chunked loops while the emission layout stays K_SYM=32
    (per-32-symbol valid counts unchanged).  This halves the sequential
    chain length, trading loop bandwidth exactly as the documented K
    scaling does; decode quality at the operating point is asserted unchanged by
    tests/test_demod_fast.py and the tune_loops floors."""
    C, T = yr.shape
    er = jnp.concatenate([tail_re, yr], axis=1)
    ei = jnp.concatenate([tail_im, yi], axis=1)
    ntaps = P.INTERP_TAP_COUNT
    Pb_np, Pd_np = _bank_polys()
    Pb = jnp.asarray(Pb_np)
    Pd = jnp.asarray(Pd_np)
    remap = jnp.asarray(_DIFF_REMAP)
    if pair is None:
        pair = (n_chunks % 2 == 0)
    H = 2 if pair else 1                 # chunks per scan step
    G = H * K_SYM                        # symbols per scan step
    assert n_chunks % H == 0, (n_chunks, H)
    kk = jnp.arange(G, dtype=jnp.float32)
    kt = jnp.arange(ntaps, dtype=jnp.int32)

    def step(carry, _):
        pos, omega, cphase, cfreq, ph2, prev_sym = carry
        # symbol positions for the whole group at frozen omega
        p = pos[:, None] + omega[:, None] * kk[None, :]       # (C, G)
        ipos = jnp.floor(p).astype(jnp.int32)
        mu = p - jnp.floor(p)
        valid = ipos < T
        safe = jnp.clip(ipos, 0, T - 1)
        idx = (safe[:, :, None] + kt[None, None, :]).reshape(C, -1)
        wre = jnp.take_along_axis(er, idx, axis=1).reshape(C, G, ntaps)
        wim = jnp.take_along_axis(ei, idx, axis=1).reshape(C, G, ntaps)
        # interpolation coefficients by Horner polynomial in mu (see
        # _bank_polys: no table lookup, no gather)
        mu1 = mu[..., None]                                    # (C, G, 1)
        c0 = Pb[0] * mu1 + Pb[1]
        cd = Pd[0] * mu1 + Pd[1]
        for j in range(2, 6):
            c0 = c0 * mu1 + Pb[j]
            cd = cd * mu1 + Pd[j]
        f0r = jnp.sum(wre * c0, axis=2)
        f0i = jnp.sum(wim * c0, axis=2)
        dr = jnp.sum(wre * cd, axis=2)
        di = jnp.sum(wim * cd, axis=2)
        sgn = lambda v: jnp.where(v > 0, 1.0, -1.0)
        # natural d/dmu derivative scale: the reference's adjacent-row
        # differences (1/128 phase step) shrink the timing S-curve slope to
        # ~1/128 of what its criticallyDamped gain design assumes, leaving
        # the clock loop at damping ~0.06 -- a noise-pumped resonance that
        # random-walks the block loop's mu estimate.  d/dmu units restore
        # slope ~0.8 and the designed ~0.7 damping; the clip scales
        # accordingly (it only exists to bound outliers).
        err = jnp.clip(sgn(f0r) * dr + sgn(f0i) * di, -4.0, 4.0)
        err = jnp.where(valid, err, 0.0)
        # ONE loop update per group, at gains scaled for the group's
        # effective chunk size (_PAIR_* scales; see their definition).
        # Chaining two same-measurement updates at the K=32 gains instead
        # (the naive pairing) doubles the loop gain at doubled update
        # latency -- measured underdamped: ~0.3% symbol errors on a CLEAN
        # channel from detector self-noise ringing.
        mu_g = _MM_MU_GAIN * (_PAIR_MU if pair else 1.0)
        om_g = _MM_OMEGA_GAIN * (_PAIR_OM if pair else 1.0)
        err_sum = jnp.sum(err, axis=1)
        n_valid = jnp.sum(valid, axis=1).astype(jnp.float32)
        omega_n = jnp.clip(omega + om_g * err_sum, _OMEGA_MIN, _OMEGA_MAX)
        # advance only past the symbols actually emitted: positions
        # beyond the block end stay queued for the next block (no
        # symbol loss at block seams, as in the exact-mode carry)
        pos = pos + omega * n_valid + mu_g * err_sum
        omega = omega_n

        # ---- Costas with freq frozen over the group ----
        # ang = (ph2 - pi/4 - cphase) + k * (-pi/4 - cfreq): a linear ramp,
        # generated by the rotator recurrence (no per-symbol transcendentals)
        c, s = rot_ramp(ph2 - np.float32(np.pi / 4.0) - cphase,
                        -np.float32(np.pi / 4.0) - cfreq, G,
                        time_first=False)
        sr = f0r * c - f0i * s
        si = f0i * c + f0r * s
        cerr = jnp.clip(sgn(sr) * si - sgn(si) * sr, -1.0, 1.0)
        cerr = jnp.where(valid, cerr, 0.0)
        # rail-gated leaky integrator: during FLL pull-in the residual
        # rotation exceeds the chunked tracking range and the aggregated
        # S-curve error loses its restoring force, so a railed integrator
        # must decay back once the FLL has taken over (exact-mode loops
        # don't need this because they update per sample).  The leak only
        # engages NEAR THE RAIL: a steady leak would demand a standing
        # phase error proportional to any sustained cfreq -- the band-edge
        # FLL parks a few Hz off on band-limited (channelized) inputs and
        # the Costas holds the difference, so an always-on leak turned that
        # into a ~0.4 rad constellation offset on every wideband channel.
        ca_g = _COSTAS_ALPHA * (_PAIR_CA if pair else 1.0)
        cb_g = _COSTAS_BETA * (_PAIR_CB if pair else 1.0)
        clim_g = _COSTAS_FREQ_LIM_CHUNKED * (_PAIR_CLIM if pair else 1.0)
        cerr_sum = jnp.sum(cerr, axis=1)
        leak = jnp.where(jnp.abs(cfreq) > 0.3 * clim_g, 0.05, 0.0)
        cfreq = jnp.clip((1.0 - leak) * cfreq + cb_g * cerr_sum,
                         -clim_g, clim_g)
        cphase_n = cphase + cfreq * n_valid + ca_g * cerr_sum
        cphase = cphase_n - 2 * np.pi * jnp.floor(
            (cphase_n + np.pi) / (2 * np.pi))
        # only cos/sin of ph2 are ever used -> mod 2 pi is sufficient
        dph2 = jnp.where(valid, np.float32(np.pi / 4.0), 0.0).sum(axis=1)
        ph2 = jnp.mod(ph2 - dph2, 2 * np.pi)

        # ---- differential extraction across the group ----
        a = (si < 0).astype(jnp.int32)
        b = (sr < 0).astype(jnp.int32)
        quad = (a << 1) | (a ^ b)
        prev = jnp.concatenate([prev_sym[:, None], quad[:, :-1]], axis=1)
        dibit = remap[(quad - prev) & 3].astype(jnp.uint8)
        # carry the last VALID quadrant
        valid_all = valid
        last_valid = jnp.where(valid_all.any(axis=1),
                               jnp.take_along_axis(
                                   quad, (jnp.sum(valid_all, axis=1) - 1)
                                   .clip(0)[:, None], axis=1)[:, 0],
                               prev_sym)
        prev_sym = last_valid
        ideal_r = jnp.where(b.astype(bool), -0.7071, 0.7071)
        ideal_i = jnp.where(a.astype(bool), -0.7071, 0.7071)
        dist = jnp.abs(jnp.arctan2(ideal_i, ideal_r) - jnp.arctan2(si, sr))
        out = (sr, si, dibit, valid, dist)
        return (pos, omega, cphase, cfreq, ph2, prev_sym), out

    carry = (pos, omega, cphase, cfreq, ph2, prev_sym)
    carry, (sre, sim, dibits, valids, dists) = jax.lax.scan(
        step, carry, None, length=n_chunks // H)
    pos, omega, cphase, cfreq, ph2, prev_sym = carry
    pos = pos - T

    def merge(x):  # (n_chunks, C, Ks) -> (C, n_chunks*Ks)
        return jnp.swapaxes(x, 0, 1).reshape(C, -1)

    outs = dict(sym_re=merge(sre), sym_im=merge(sim), dibits=merge(dibits),
                valid=merge(valids), dist=merge(dists))
    return (outs, er[:, T:], ei[:, T:], pos, omega, cphase, cfreq, ph2,
            prev_sym)


# ---------------------------------------------------------------------------
# Full chain
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_chunks", "tc_out"))
def _demod_block_impl(state: FastDemodState, xr, xi, n_chunks: int,
                      tc_out: bool = False):
    """tc_out: additionally expose dibits/valid/dist in the TIME-MAJOR
    (T, C) layout (keys *_tc) that the superblock wideband path packs for
    the fleet feed.  The channel-major keys remain for all other consumers
    (dead-code-eliminated when unused inside an outer jit)."""
    rrc, be, _ = _tables()
    rotr, roti, gain, fphase, ffreq, fhre, fhim = _agc_fll_chunked(
        xr, xi, state.agc_gain, state.fll_phase, state.fll_freq,
        state.fll_hist_re, state.fll_hist_im, be)
    mfr, mfi, rtr, rti = fir_stream_pair(
        rotr, roti, jnp.asarray(rrc), state.rrc_tail_re, state.rrc_tail_im)
    (outs, mtr, mti, pos, omega, cphase, cfreq, ph2, prev_sym) = (
        _mm_costas_chunked(mfr, mfi, state.mm_tail_re, state.mm_tail_im,
                           state.mm_pos, state.mm_omega, state.cos_phase,
                           state.cos_freq, state.cos_ph2, state.prev_sym,
                           n_chunks))
    new_state = FastDemodState(
        agc_gain=gain, fll_phase=fphase, fll_freq=ffreq,
        fll_hist_re=fhre, fll_hist_im=fhim, rrc_tail_re=rtr, rrc_tail_im=rti,
        mm_tail_re=mtr, mm_tail_im=mti, mm_pos=pos, mm_omega=omega,
        cos_phase=cphase, cos_freq=cfreq, cos_ph2=ph2, prev_sym=prev_sym)
    outs["fll_freq"] = ffreq
    outs["agc_gain"] = gain
    if tc_out:
        _add_tc_from_cm(outs)
    return new_state, outs


def _add_tc_from_cm(outs: dict) -> None:
    """Derive the time-major *_tc keys from the channel-major outputs."""
    outs["dibits_tc"] = jnp.swapaxes(outs["dibits"], 0, 1).astype(jnp.int32)
    outs["valid_tc"] = jnp.swapaxes(outs["valid"], 0, 1).astype(jnp.int32)
    outs["dist_tc"] = jnp.swapaxes(outs["dist"], 0, 1)


def demod_block(state: FastDemodState, iq: np.ndarray):
    """Chunked-mode demod of one (C, T) complex block (complex only at the
    host boundary).  T must be a multiple of K_SAMP."""
    iq = np.atleast_2d(iq)
    T = iq.shape[1]
    n_chunks = n_chunks_for(T)
    xr = jnp.asarray(np.ascontiguousarray(iq.real, dtype=np.float32))
    xi = jnp.asarray(np.ascontiguousarray(iq.imag, dtype=np.float32))
    return _demod_block_impl(state, xr, xi, n_chunks)


@partial(jax.jit, static_argnames=("n_chunks",))
def _demod_scan_impl(state, xr_k, xi_k, n_chunks: int):
    def body(st, xs):
        xr, xi = xs
        return _demod_block_impl(st, xr, xi, n_chunks)
    return jax.lax.scan(body, state, (xr_k, xi_k))


def demod_blocks(state: FastDemodState, iq: np.ndarray):
    """Bulk-throughput demod of (k, C, T) stacked blocks in ONE device call.

    `lax.scan` runs the per-block pipeline k times inside a single jitted
    program: the compiled program size stays that of one block while the
    fixed per-dispatch host overhead amortizes across k blocks.
    State streams across blocks exactly as k sequential demod_block calls
    (tests/test_demod_fast.py asserts equality).  Outputs are stacked with
    a leading k axis.  Adds k*T/36e3 seconds of latency: use for bulk/
    offline decode; live paths keep per-block calls.
    """
    iq = np.asarray(iq)
    assert iq.ndim == 3
    T = iq.shape[2]
    n_chunks = n_chunks_for(T)
    xr = jnp.asarray(np.ascontiguousarray(iq.real, dtype=np.float32))
    xi = jnp.asarray(np.ascontiguousarray(iq.imag, dtype=np.float32))
    return _demod_scan_impl(state, xr, xi, n_chunks)
