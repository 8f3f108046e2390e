"""Gated A/B variants must keep their documented properties: PAIR_STAGE1,
TETRA_AGC_RMS and FLL_DECIM=1 are kept in-tree as
recorded negatives / A/B levers, so a refactor that silently breaks a
non-default path must fail CI, not the next measurement session.

Each flag is a trace-time module constant: the tests mutate the module
attribute and clear the demod jit caches around the run (the documented
contract -- see demod_fast.FLL_DECIM's note; runtime mutation after a
trace is cached is not supported, which is exactly why these need CI
coverage rather than ad-hoc flipping)."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp


from tetra_tpu import params as P
from tetra_tpu.rx import demod as demod_exact
from tetra_tpu.rx import demod_fast
from tetra_tpu.tx.channel import channel
from tetra_tpu.tx.modulator import modulate

RNG = np.random.default_rng(23)


@contextlib.contextmanager
def _variant(**flags):
    saved = {k: getattr(demod_fast, k) for k in flags}
    for k, v in flags.items():
        setattr(demod_fast, k, v)
    demod_fast._demod_block_impl.clear_cache()
    demod_fast._demod_scan_impl.clear_cache()
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(demod_fast, k, v)
        demod_fast._demod_block_impl.clear_cache()
        demod_fast._demod_scan_impl.clear_cache()


def _run(iq, block=4096):
    state = demod_fast.demod_init(iq.shape[0])
    dibs, vals, dists = [], [], []
    for i in range(iq.shape[1] // block):
        state, outs = demod_fast.demod_block(
            state, iq[:, i * block:(i + 1) * block])
        v = np.asarray(outs["valid"])[0]
        dibs.append(np.asarray(outs["dibits"])[0][v])
        dists.append(np.asarray(outs["dist"])[0][v])
    return np.concatenate(dibs), np.concatenate(dists), state


def _ber(tx_bits, rx_bits, skip, probe=400):
    pat = tx_bits[skip:skip + probe]
    errs = [np.mean(rx_bits[o:o + probe] != pat)
            for o in range(len(rx_bits) - probe)]
    off = int(np.argmin(errs))
    n = min(len(rx_bits) - off, len(tx_bits) - skip)
    return float(np.mean(rx_bits[off:off + n] != tx_bits[skip:skip + n]))


def _operating_point_iq(n_bits=61440):
    bits = RNG.integers(0, 2, (1, n_bits)).astype(np.uint8)
    iq = modulate(jnp.asarray(bits))
    iq = np.asarray(channel(iq, jax.random.key(7), snr_db=20.0,
                            cfo_hz=600.0, sample_rate=P.SAMPLE_RATE))
    return bits, iq


def test_pair_stage1_passes_operating_point():
    """PAIR_STAGE1=True (stage-1 compute pairing, off by default): the
    quality gates it passed when measured must keep passing -- 600 Hz
    pull-in at 20 dB with near-zero BER."""
    bits, iq = _operating_point_iq()
    with _variant(PAIR_STAGE1=True):
        rx, _, state = _run(iq)
        ber = _ber(bits[0], demod_exact.dibits_to_bits(rx), skip=42000)
        assert ber < 1e-3, ber
        fhz = float(state.fll_freq[0]) * P.SAMPLE_RATE / (2 * np.pi)
        assert abs(fhz - 600.0) < 80.0, fhz


def test_agc_rms_still_decodes():
    """TETRA_AGC_RMS=1 (kappa*RMS amplitude estimator): its recorded gate
    failure is a CLEAN-FLOOR regression (0.0105 -> 0.0423 rad), not
    brokenness -- a clean channel must still decode BER-0 with the floor
    in the documented band."""
    bits = RNG.integers(0, 2, (1, 24000)).astype(np.uint8)
    iq = np.asarray(modulate(jnp.asarray(bits)))
    with _variant(AGC_RMS=True):
        rx, dist, _ = _run(iq)
        ber = _ber(bits[0], demod_exact.dibits_to_bits(rx), skip=4000)
        assert ber == 0.0, ber
        floor = dist[4000:].mean()
        # documented: ~4x the mean-|.| floor, still far under the 0.35 rad
        # symbol gate; anchor well above the measured 0.0423 but low enough
        # that a broken estimator (limit cycle, wrong kappa) fails
        assert floor < 0.09, floor


def test_fll_decim_1_reference_behavior():
    """FLL_DECIM=1 (undecimated band-edge error taps = reference behavior,
    the r4 A/B baseline): must hold the pre-decimation quality -- BER-0 on
    clean input with the ~0.0105 rad floor band, and the 600 Hz operating
    point within its gate."""
    with _variant(FLL_DECIM=1):
        bits = RNG.integers(0, 2, (1, 24000)).astype(np.uint8)
        iq = np.asarray(modulate(jnp.asarray(bits)))
        rx, dist, _ = _run(iq)
        assert _ber(bits[0], demod_exact.dibits_to_bits(rx), skip=4000) == 0.0
        floor = dist[4000:].mean()
        assert floor < 0.03, floor      # r4 measured ~0.0105 clean at D=1

        bits2, iq2 = _operating_point_iq()
        rx2, _, state = _run(iq2)
        ber = _ber(bits2[0], demod_exact.dibits_to_bits(rx2), skip=42000)
        assert ber < 1e-3, ber
        fhz = float(state.fll_freq[0]) * P.SAMPLE_RATE / (2 * np.pi)
        assert abs(fhz - 600.0) < 80.0, fhz


def test_fll_decim_validation_rejects_bad_values():
    """The module-level D validation (ADVICE r4) must reject odd D > 1
    (all-even comb parity bias) and non-divisors of K_SAMP."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for bad in ("3", "5", "7", "24"):
        r = subprocess.run(
            [sys.executable, "-c",
             "import jax; jax.config.update('jax_platforms', 'cpu'); "
             "from tetra_tpu.rx import demod_fast"],
            env={"PATH": "/usr/bin:/bin", "TETRA_FLL_DECIM": bad,
                 "PYTHONPATH": repo},
            capture_output=True, text=True)
        assert r.returncode != 0 and "TETRA_FLL_DECIM" in r.stderr, \
            (bad, r.stderr[-500:])
