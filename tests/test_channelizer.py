"""Channelizer + resampler + wideband multichannel end-to-end tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tetra_tpu import params as P
from tetra_tpu.parallel import channelizer as CH
from tetra_tpu.rx.receiver import TetraReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu.tx.modulator import modulate
from tetra_tpu.tx.wideband import assemble_wideband

RNG = np.random.default_rng(44)


def test_channel_tone_mapping():
    N = 16
    fs = N * 25000.0
    t = np.arange(32768) / fs
    for k, df in ((3, 4000.0), (9, -6000.0)):
        f0 = k * 25000.0 + df
        if f0 > fs / 2:
            f0 -= fs
        wide = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
        ch = CH.channelize(wide, N)
        p = np.mean(np.abs(ch) ** 2, axis=1)
        assert int(np.argmax(p)) == k
        # adjacent leakage well suppressed
        assert 10 * np.log10(sorted(p)[-2] / p[k]) < -40
        z = ch[k][300:3000]
        fmeas = np.angle(np.mean(z[1:] * np.conj(z[:-1]))) * 50000 / (2 * np.pi)
        assert abs(fmeas - df) < 20


def test_resampler_phase_exact():
    z = np.exp(2j * np.pi * 5000 * np.arange(20000) / 50000).astype(np.complex64)
    y = CH.resample_50_to_36(z[None])[0]
    d = np.diff(np.unwrap(np.angle(y[200:800])))
    assert abs(d.mean() - 2 * np.pi * 5000 / 36000) < 1e-4
    assert d.std() < 1e-3


def test_wideband_16ch_multicell_decode():
    """BASELINE config 3: wideband capture -> channelizer -> batched demod ->
    per-channel cell decode."""
    N = 16
    start = TdmaTime(mn=1, fn=17, tn=4)
    cells = {
        2: cell.CellConfig(mcc=244, mnc=100, cc=1),
        7: cell.CellConfig(mcc=262, mnc=200, cc=2),
        12: cell.CellConfig(mcc=208, mnc=300, cc=3),
    }
    chans = {}
    for k, cfg in cells.items():
        bits, _ = cell.downlink_bits(cfg, 170, start=start.copy())
        chans[k] = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
    wide = assemble_wideband(chans, N, amplitude=0.5)
    # channelize + resample all N channels, feed the batched receiver
    ch50 = CH.channelize(wide, N)
    ch36 = CH.resample_50_to_36(ch50)
    rx = TetraReceiver(len(cells))
    occupied = sorted(cells)
    iq = np.stack([ch36[k] for k in occupied])
    T = 4096
    for i in range(iq.shape[1] // T):
        rx.process(iq[:, i * T:(i + 1) * T])
    for c, k in enumerate(occupied):
        d = rx.display(c)
        assert rx.locked(c), (c, k)
        assert d.mcc == cells[k].mcc, (c, k, d.mcc)
        assert d.mnc == cells[k].mnc
        assert d.cc == cells[k].cc


def test_wideband_operating_region_20db():
    """Full wideband path at the BASELINE operating point: 20 dB SNR + CFO
    on the wideband capture, channelize -> resample -> demod -> MAC; the
    occupied channel must lock and decode its cell cleanly (the cascade
    filters are flat over the RRC band, so the narrowband operating region
    carries over)."""
    import jax
    from tetra_tpu import params as P
    from tetra_tpu.rx.burst_sync import BurstSync, RX_LOCKED
    from tetra_tpu.rx.demod import dibits_to_bits
    from tetra_tpu.rx import demod_fast
    from tetra_tpu.rx.lower_mac import LowerMac
    from tetra_tpu.rx.tdma import TdmaTime
    from tetra_tpu.tx import cell
    from tetra_tpu.tx.channel import channel as chan
    from tetra_tpu.tx.modulator import modulate
    from tetra_tpu.tx.wideband import assemble_wideband

    N = 16
    cfg = cell.CellConfig()
    bits, _ = cell.downlink_bits(cfg, 170, start=TdmaTime(mn=1, fn=17, tn=4))
    x = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
    wide = assemble_wideband({5: x}, N)
    # impair at the WIDEBAND rate: AWGN across the whole band + CFO
    wide = np.asarray(chan(jnp.asarray(wide[None]), jax.random.key(3),
                           snr_db=20.0 - 10 * np.log10(N / 2), cfo_hz=300.0,
                           sample_rate=N * 25_000.0))[0]
    y = CH.resample_50_to_36(CH.channelize(wide, N))[5]
    sync = BurstSync()
    mac = LowerMac(phy=sync.phy)
    st = demod_fast.demod_init(1)
    T = (len(y) // 4096) * 4096
    for i in range(T // 4096):
        st, outs = demod_fast.demod_block(st, y[None, i * 4096:(i + 1) * 4096])
        v = np.asarray(outs["valid"])[0]
        bursts = sync.feed(dibits_to_bits(np.asarray(outs["dibits"])[0][v]))
        if bursts:
            mac.process_bursts(bursts)
    assert sync.state == RX_LOCKED
    d = mac.upper.display
    assert (d.mcc, d.mnc, d.cc) == (cfg.mcc, cfg.mnc, cfg.cc)
    # acquisition may consume up to two SYNC periods at 20 dB with CFO
    # (same allowance as the narrowband operating-region test)
    assert mac.crc_oks >= 60


def test_resampler_matmul_matches_direct_definition():
    """The banded-matmul resampler (gather-free, _resamp_matrix) must equal
    the direct polyphase definition y[n] = sum_t x[(nM)//L + t - pad] *
    flip(bank[(nM)%L])[t] for both rates, and the streaming variant must be
    seam-exact across blocks."""
    taps = CH.RS_TAPS_PER_PHASE
    pad = taps - 1
    rng = np.random.default_rng(0)
    for (L, M) in ((18, 25), (25, 18)):
        n_in = 2000
        x = rng.standard_normal(n_in).astype(np.float32)
        bank = CH._resamp_bank(L, M)
        n_out = (n_in - taps) * L // M
        xp = np.concatenate([np.zeros(pad, np.float32), x])
        y_ref = np.array(
            [(xp[(n * M) // L:(n * M) // L + taps]
              * bank[(n * M) % L][::-1]).sum() for n in range(n_out)],
            np.float32)
        yr, _ = CH._resample_block(jnp.asarray(x), jnp.asarray(x), n_in, L, M)
        assert np.abs(np.asarray(yr) - y_ref).max() < 2e-5

    L, M = 18, 25
    t_in, t_out = 1000, 720
    x = rng.standard_normal(3 * t_in).astype(np.float32)
    hr = hi = jnp.zeros(pad, np.float32)
    outs = []
    for b in range(3):
        xb = jnp.asarray(x[b * t_in:(b + 1) * t_in])
        yr, yi, hr, hi = CH._resample_stream_block(xb, xb, hr, hi, t_out, L, M)
        outs.append(np.asarray(yr))
    xc = np.concatenate([np.zeros(pad, np.float32), x])
    bank = CH._resamp_bank(L, M)
    y_ref = np.array(
        [(xc[(n * M) // L:(n * M) // L + taps]
          * bank[(n * M) % L][::-1]).sum() for n in range(3 * t_out)],
        np.float32)
    assert np.abs(np.concatenate(outs) - y_ref).max() < 2e-5


def test_stacked_multiplex_batching_is_exact():
    """G independent multiplexes channelized per stream and demodulated as
    one C=G*n_ch batch (the bench_wideband G-stacking that amortizes the
    backend's fixed dispatch cost) must produce bitwise-identical demod
    outputs to processing each multiplex alone -- pure batching, no
    semantic coupling across the G axis."""
    from tetra_tpu.rx import demod_fast as demod_mod

    n_ch, t50, G = 16, 1600, 3
    t36 = t50 * 18 // 25
    hop = n_ch // 2
    L = n_ch * CH.TAPS_PER_BRANCH
    wide_len = (t50 - 1) * hop + L
    n_chunks = int(np.ceil(t36 / (demod_mod.K_SYM * 1.96))) + 1
    w = RNG.standard_normal((G, 2, wide_len)).astype(np.float32)

    def run_single(g):
        yr, yi = CH._channelize_block(jnp.asarray(w[g, 0]),
                                      jnp.asarray(w[g, 1]), n_ch)
        hist = jnp.zeros((n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
        rr, ri, _, _ = CH._resample_stream_block(yr, yi, hist, hist, t36)
        st = demod_mod.demod_init(n_ch)
        _, outs = demod_mod._demod_block_impl(st, rr, ri, n_chunks)
        return np.asarray(outs["dibits"]), np.asarray(outs["valid"])

    chan_g = jax.vmap(lambda r, i: CH._channelize_block(r, i, n_ch))
    yr, yi = chan_g(jnp.asarray(w[:, 0]), jnp.asarray(w[:, 1]))
    yr = yr.reshape(G * n_ch, t50)
    yi = yi.reshape(G * n_ch, t50)
    hist = jnp.zeros((G * n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
    rr, ri, _, _ = CH._resample_stream_block(yr, yi, hist, hist, t36)
    st = demod_mod.demod_init(G * n_ch)
    _, outs = demod_mod._demod_block_impl(st, rr, ri, n_chunks)
    dib = np.asarray(outs["dibits"]).reshape(G, n_ch, -1)
    val = np.asarray(outs["valid"]).reshape(G, n_ch, -1)
    for g in range(G):
        dib1, val1 = run_single(g)
        assert np.array_equal(val[g], val1), g
        assert np.array_equal(dib[g][val[g]], dib1[val1]), g


def test_frame_major_resampler_matches_channel_major():
    """_resample_stream_block_fm (superblock left-matmul, channels on
    lanes) == _resample_stream_block (channel-major) across streamed
    blocks, up to matmul summation order."""
    C, t50, t36 = 16, 800, 576
    pad = CH.RS_TAPS_PER_PHASE - 1
    x = RNG.standard_normal((2, C, 3 * t50)).astype(np.float32)
    h_cm = jnp.zeros((C, pad), jnp.float32)
    h_fm = jnp.zeros((pad, C), jnp.float32)
    hr_cm = hi_cm = h_cm
    hr_fm = hi_fm = h_fm
    for b in range(3):
        xr = jnp.asarray(x[0, :, b * t50:(b + 1) * t50])
        xi = jnp.asarray(x[1, :, b * t50:(b + 1) * t50])
        yr_cm, yi_cm, hr_cm, hi_cm = CH._resample_stream_block(
            xr, xi, hr_cm, hi_cm, t36)
        yr_fm, yi_fm, hr_fm, hi_fm = CH._resample_stream_block_fm(
            xr.T, xi.T, hr_fm, hi_fm, t36)
        np.testing.assert_allclose(np.asarray(yr_fm).T, np.asarray(yr_cm),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(np.asarray(yi_fm).T, np.asarray(yi_cm),
                                   rtol=0, atol=2e-5)
        np.testing.assert_array_equal(np.asarray(hr_fm).T,
                                      np.asarray(hr_cm))


def test_fused_wideband_receiver_decodes_multicell():
    """TetraReceiver(wideband=N): the fused one-program cascade
    (channelize -> streaming resample -> demod, process_wideband with
    internal buffering) locks and decodes the same multiplex as the split
    host path, including across odd-sized raw feeds and a checkpoint
    round-trip."""
    N = 16
    start = TdmaTime(mn=1, fn=17, tn=4)
    cells = {
        2: cell.CellConfig(mcc=244, mnc=100, cc=1),
        7: cell.CellConfig(mcc=262, mnc=200, cc=2),
    }
    chans = {}
    for k, cfg in cells.items():
        bits, _ = cell.downlink_bits(cfg, 260, start=start.copy())
        chans[k] = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
    wide = assemble_wideband(chans, N, amplitude=0.5)

    rx = TetraReceiver(wideband=N, t50=1600)  # t36=1152 per block
    assert rx.channels == N
    # deliberately awkward chunking: the receiver must reassemble windows
    step = 50_001
    fed = 0
    ckpt_done = False
    import tempfile, os
    ckpt = os.path.join(tempfile.gettempdir(), "wb_ckpt.npz")
    while fed < len(wide):
        rx.process_wideband(wide[fed:fed + step])
        fed += step
        if not ckpt_done and fed > len(wide) // 2:
            rx.save_state(ckpt)      # mid-stream checkpoint
            rx2 = TetraReceiver(wideband=N, t50=1600)
            rx2.load_state(ckpt)
            rx = rx2                 # resume and continue on the clone
            ckpt_done = True
    assert ckpt_done
    for k, cfg in cells.items():
        d = rx.display(k)
        assert rx.locked(k), k
        assert (d.mcc, d.mnc, d.cc) == (cfg.mcc, cfg.mnc, cfg.cc), k
        ok, fail = rx.crc_counts(k)
        assert ok > 100, (k, ok, fail)


def _wideband_stream(n_ch, t50, n_blk, seed):
    hop = n_ch // 2
    wide_len = (t50 - 1) * hop + n_ch * CH.TAPS_PER_BRANCH
    n = t50 * hop * (n_blk - 1) + wide_len
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64), wide_len, t50 * hop


@pytest.mark.parametrize("n_ch,t50", [(16, 800), (16, 775), (32, 1600)])
def test_channelizer_matches_float64_filterbank(n_ch, t50):
    """The slice+matmul channelizer == the textbook float64 filterbank
    (windowed frames, branch fold, FFT, hop-phase sign)."""
    from tetra_tpu.parallel import channelizer_ref
    x, wide_len, _ = _wideband_stream(n_ch, t50, 1, seed=n_ch + t50)
    yr, yi = CH._channelize_block(jnp.asarray(x.real.copy()),
                                  jnp.asarray(x.imag.copy()), n_ch)
    got = (np.asarray(yr) + 1j * np.asarray(yi)).T          # (t50, n_ch)
    want = channelizer_ref.filterbank(x.astype(np.complex128), n_ch, t50)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-6, rel


@pytest.mark.parametrize("n_ch,t50", [(16, 1600), (32, 800)])
def test_fused_front_end_matches_unfused_composition(n_ch, t50):
    """_front_end_block (frame-major channelize + superblock resampler) over
    streamed blocks == the channel-major channelizer + streaming resampler
    composition, and both == the float64 reference front end."""
    from tetra_tpu.parallel import channelizer_ref
    n_blk = 2
    t36 = t50 * 18 // 25
    x, wide_len, advance = _wideband_stream(n_ch, t50, n_blk, seed=7)
    pad = CH.RS_TAPS_PER_PHASE - 1
    hf_r = hf_i = jnp.zeros((pad, n_ch), jnp.float32)
    hu_r = hu_i = jnp.zeros((n_ch, pad), jnp.float32)
    fused, unfused = [], []
    for b in range(n_blk):
        w = x[b * advance: b * advance + wide_len]
        xr, xi = jnp.asarray(w.real.copy()), jnp.asarray(w.imag.copy())
        rr, ri, hf_r, hf_i = CH._front_end_block(xr, xi, hf_r, hf_i,
                                                 n_ch, t36)
        fused.append(np.asarray(rr) + 1j * np.asarray(ri))
        yr, yi = CH._channelize_block(xr, xi, n_ch)
        ur, ui, hu_r, hu_i = CH._resample_stream_block(yr, yi, hu_r, hu_i,
                                                       t36)
        unfused.append((np.asarray(ur) + 1j * np.asarray(ui)).T)
    fused = np.concatenate(fused)
    unfused = np.concatenate(unfused)
    np.testing.assert_allclose(fused, unfused, rtol=0, atol=2e-5)
    want = channelizer_ref.front_end(x.astype(np.complex128), n_ch,
                                     n_blk * t50, n_blk * t36)
    rel = np.linalg.norm(fused - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel
