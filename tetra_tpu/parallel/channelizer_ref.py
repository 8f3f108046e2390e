"""Plain float64 NumPy references for the wideband front end
(parallel/channelizer.py), written from the textbook definitions and
independent of its slice/matmul formulation: chip_smoke.py and the tests
compare the device front end against them.
"""

from __future__ import annotations

import numpy as np

from ..core.taps import nuttall
from . import channelizer as CH


def filterbank(x: np.ndarray, n_ch: int, n_out: int) -> np.ndarray:
    """float64 textbook 2x-oversampled polyphase DFT filterbank: frame m is
    x[m*hop : m*hop + L] weighted by the prototype, folded over the
    TAPS_PER_BRANCH branches of n_ch samples, FFT'd, with the hop-phase sign
    (-1)^(m k).  Returns (n_out, n_ch) complex128."""
    from numpy.lib.stride_tricks import sliding_window_view
    hop = n_ch // 2
    L = n_ch * CH.TAPS_PER_BRANCH
    h = prototype(n_ch)
    frames = sliding_window_view(x, L)[::hop][:n_out]
    out = np.empty((n_out, n_ch), np.complex128)
    for s in range(0, n_out, 512):
        f = (frames[s:s + 512] * h).reshape(-1, CH.TAPS_PER_BRANCH, n_ch)
        out[s:s + 512] = np.fft.fft(f.sum(axis=1), axis=1)
    m = np.arange(n_out)[:, None]
    k = np.arange(n_ch)[None, :]
    return out * np.where((m * k) % 2 == 1, -1.0, 1.0)


def prototype(n_ch: int) -> np.ndarray:
    """float64 Nuttall-windowed-sinc prototype, cutoff 0.53/n_ch, unit DC
    gain per branch (the design of channelizer._prototype)."""
    L = n_ch * CH.TAPS_PER_BRANCH
    n = np.arange(L)
    cutoff = 0.53 / n_ch
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - (L - 1) / 2.0)) * nuttall(n, L)
    return h / h.sum() * n_ch


def resampler(y: np.ndarray, n_out: int) -> np.ndarray:
    """float64 18/25 rational resampler (upsample, filter, downsample) over
    the channel streams y (T, C) from zero history; returns (n_out, C)."""
    from scipy.signal import upfirdn
    Lr, Mr = 18, 25
    total = Lr * CH.RS_TAPS_PER_PHASE
    n = np.arange(total)
    cutoff = 0.48 / max(Lr, Mr)
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - (total - 1) / 2.0)) \
        * nuttall(n, total)
    h = h * (Lr / h.sum())
    return upfirdn(h, y, up=Lr, down=Mr, axis=0)[:n_out]


def front_end(x: np.ndarray, n_ch: int, t50: int, t36: int) -> np.ndarray:
    """Wideband x at n_ch*25 kHz -> (t36, n_ch) channel streams at 36 kHz:
    filterbank(), then resampler() from zero history."""
    return resampler(filterbank(x, n_ch, t50), t36)
