"""Full-pipeline benchmark: wideband IQ -> decoded PDUs (ONE number).

Measures the PRODUCTION receiver end to end -- channelize + 18/25 resample +
chunked demod (one fused device program), native fleet burst sync, batched
mixed-FEC device decode, native MAC dispatch, display state -- nothing
excluded: the demod-only line of bench.py measures the front half only;
this measures everything a deployed receiver does per second of air.

Usage (one GPU; stops with exit code 2 when JAX finds none):
    python scripts/bench_e2e.py [--channels 256] [--t50 6400] [--k 4]
    python scripts/bench_e2e.py --resident --k 32 --seconds 16
    python scripts/bench_e2e.py --sweep          # config ladder

The input is a G-cell wideband multiplex built from the TX fixture
(locked steady state), impaired with per-channel-group CFO and noise.
Throughput is wideband complex samples/s through the WHOLE stack, plus the
real-time channel-multiplex count; decode-level sanity (locks + CRC-clean
blocks) is asserted so the number can't be gamed by a broken pipeline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def multiplex_cells(channels: int):
    """The multiplex's cell on each carrier: min(8, channels) distinct cells
    (MCC 262, MNC 100+i, CC 1+i) repeated over the carriers; carrier c
    carries cell c % n_cells."""
    from tetra_tpu.tx import cell
    n_cells = min(8, channels)
    cells = [cell.CellConfig(mcc=262, mnc=100 + i, cc=1 + i)
             for i in range(n_cells)]
    return [cells[c % n_cells] for c in range(channels)]


def build_wideband(channels: int, seconds: float, seed: int = 7):
    """A locked TETRA multiplex on every carrier of an N x 25 kHz wideband
    stream (multiplex_cells: distinct cells per carrier group), with noise
    and a per-carrier CFO of +-400 Hz at 25 dB SNR."""
    from tetra_tpu.tx import cell
    from tetra_tpu.tx.wideband import synthesize_wideband
    from tetra_tpu.rx.tdma import TdmaTime

    n_slots = int(seconds / 0.014167) + 4
    cells = multiplex_cells(channels)
    n_cells = min(8, channels)
    streams = []
    for i in range(n_cells):
        # start so the SECOND decodable SYNC burst lands just past the
        # demod convergence transient (~10 slots): scrambling is learned at
        # slot ~17 and the cold-start CRC-fail fraction stays small
        bits, _ = cell.downlink_bits(cells[i], n_slots,
                                     start=TdmaTime(mn=2, fn=14, tn=1))
        streams.append(bits)
    L = min(len(s) for s in streams)
    bitmat = np.stack([streams[c % n_cells][:L] for c in range(channels)])
    rng = np.random.default_rng(seed)
    cfo = rng.uniform(-400.0, 400.0, channels)
    wide = synthesize_wideband(bitmat, channels, cfo_hz=cfo, snr_db=25.0,
                               seed=seed)
    return np.asarray(wide, np.complex64)


def measure_resident(channels: int = 256, t50: int = 6400, k: int = 16,
                     seconds: float = 2.0, pipeline: bool = False) -> dict:
    """Device-staged ingest e2e measurement (importable; bench.py emits it
    as the whole-receiver line): every superblock's (K, wide_len) window
    stack is uploaded to device memory up front;
    the timed loop runs dispatch + fetch + native fleet + FEC + MAC only
    (= the production pipeline when the SDR DMAs into device buffers).
    Decode-level sanity is asserted (>90% locks, CRC-clean dominated)."""
    import time as _time

    import jax

    from tetra_tpu.rx.receiver import TetraReceiver

    wide = build_wideband(channels, seconds + 1.5)
    rx = TetraReceiver(wideband=channels, t50=t50, fleet=True,
                       events=False, wb_k=k, wb_pipeline=pipeline)
    wb = rx._wb
    adv, wlen = wb["advance"], wb["wide_len"]
    sb_adv = k * adv
    n_super = (len(wide) - wlen) // sb_adv
    t_up0 = _time.perf_counter()
    staged = []
    for s in range(n_super):
        base = s * sb_adv
        wr = np.stack([wide[base + j * adv: base + j * adv + wlen].real
                       for j in range(k)]).astype(np.float32)
        wi = np.stack([wide[base + j * adv: base + j * adv + wlen].imag
                       for j in range(k)]).astype(np.float32)
        staged.append((jax.device_put(wr), jax.device_put(wi)))
    for wr, wi in staged:
        wr.block_until_ready(), wi.block_until_ready()
    up_s = _time.perf_counter() - t_up0
    up_bytes = sum(w[0].nbytes + w[1].nbytes for w in staged)
    # warmup: compile + FLL pull-in + scrambling acquisition (~1.5 s air)
    fs = channels * 25_000
    warm_super = max(1, int(1.5 * fs / sb_adv) + 1)
    assert n_super - warm_super >= 2, (
        f"seconds={seconds} too short: {n_super} superblocks total, "
        f"{warm_super} needed for warmup at k={k}")
    for s in range(warm_super):
        rx.process_wideband_staged(*staged[s])
    rx.flush_wideband()
    ok0 = sum(rx.crc_counts(c)[0] for c in range(channels))
    fail0 = sum(rx.crc_counts(c)[1] for c in range(channels))
    t0 = _time.perf_counter()
    sb_wall = []
    for s in range(warm_super, n_super):
        ts = _time.perf_counter()
        rx.process_wideband_staged(*staged[s])
        sb_wall.append(_time.perf_counter() - ts)
    rx.flush_wideband()
    dt = _time.perf_counter() - t0
    processed = (n_super - warm_super) * sb_adv
    n_locked = sum(rx.locked(c) for c in range(channels))
    oks = sum(rx.crc_counts(c)[0] for c in range(channels)) - ok0
    fails = sum(rx.crc_counts(c)[1] for c in range(channels)) - fail0
    msps = processed / dt / 1e6
    rt = msps * 1e6 / fs
    assert n_locked > channels * 0.9, f"only {n_locked} locked"
    assert oks > 3 * fails, (oks, fails)
    # LATENCY: a streaming receiver buffers one
    # superblock of air (k cycles) before its first sample can decode, then
    # pays the superblock's processing wall time; IQ->PDU latency for the
    # FIRST sample of a superblock ~= sb_air + wall, for the LAST ~= wall.
    # (wb_pipeline adds one more sb_air of lag -- part of why sync is the
    # default.)  rt_margin is air-time/wall-time per superblock: > 1 means
    # the receiver keeps up in real time with that factor of headroom.
    sw = np.asarray(sb_wall)
    sb_air = sb_adv / fs
    lag_sb = 1 + (1 if pipeline else 0)
    return dict(channels=channels, t50=t50, resident=True, k=k,
                pipeline=bool(pipeline),
                wideband_msps=round(msps, 1),
                rt_multiplexes=round(rt, 2),
                rt_channels=int(rt * channels),
                locked=n_locked, crc_ok=oks, crc_fail=fails,
                seconds_air=round(processed / fs, 2),
                wall=round(dt, 2),
                host_upload_MBps=round(up_bytes / up_s / 1e6, 1),
                sb_air_ms=round(sb_air * 1e3, 1),
                sb_wall_ms=round(float(sw.mean()) * 1e3, 1),
                sb_wall_p95_ms=round(float(np.percentile(sw, 95)) * 1e3, 1),
                latency_first_ms=round(
                    (lag_sb * sb_air + float(sw.mean())) * 1e3, 1),
                latency_last_ms=round(float(sw.mean()) * 1e3, 1),
                rt_margin=round(sb_air / float(sw.mean()), 2))


def measure_dual(channels_per: int = 512, t50: int = 6400, k: int = 16,
                 seconds: float = 2.0) -> dict:
    """TWO resident wideband receivers round-robined on ONE device:
    capacity from multiplexing two channels_per-channel programs over the
    device (the dense (N, N) DFT basis of one wide channelizer grows
    O(N^2)) -- identical shapes, one
    compiled program set, two receiver states + fleet engines, two
    independent wideband spectra (2 x channels_per x 25 kHz of air).
    Decode sanity asserted per instance."""
    import time as _time

    import jax

    from tetra_tpu.rx.receiver import TetraReceiver

    rxs, stageds = [], []
    fs = channels_per * 25_000
    for inst in range(2):
        wide = build_wideband(channels_per, seconds + 1.5, seed=7 + inst)
        rx = TetraReceiver(wideband=channels_per, t50=t50, fleet=True,
                           events=False, wb_k=k)
        wb = rx._wb
        adv, wlen = wb["advance"], wb["wide_len"]
        sb_adv = k * adv
        n_super = (len(wide) - wlen) // sb_adv
        staged = []
        for s in range(n_super):
            base = s * sb_adv
            wr = np.stack([wide[base + j * adv: base + j * adv + wlen].real
                           for j in range(k)]).astype(np.float32)
            wi = np.stack([wide[base + j * adv: base + j * adv + wlen].imag
                           for j in range(k)]).astype(np.float32)
            staged.append((jax.device_put(wr), jax.device_put(wi)))
        for wr, wi in staged:
            wr.block_until_ready(), wi.block_until_ready()
        rxs.append(rx)
        stageds.append(staged)
        del wide
    sb_adv = k * rxs[0]._wb["advance"]
    n_super = min(len(s) for s in stageds)
    warm_super = max(1, int(1.5 * fs / sb_adv) + 1)
    assert n_super - warm_super >= 2, (n_super, warm_super)
    for s in range(warm_super):
        for rx, staged in zip(rxs, stageds):
            rx.process_wideband_staged(*staged[s])
    base_cnt = []
    for rx in rxs:
        rx.flush_wideband()
        base_cnt.append([rx.crc_counts(c) for c in range(channels_per)])
    t0 = _time.perf_counter()
    sb_wall = []
    for s in range(warm_super, n_super):
        ts = _time.perf_counter()
        for rx, staged in zip(rxs, stageds):
            rx.process_wideband_staged(*staged[s])
        sb_wall.append(_time.perf_counter() - ts)
    for rx in rxs:
        rx.flush_wideband()
    dt = _time.perf_counter() - t0
    processed = 2 * (n_super - warm_super) * sb_adv    # both spectra
    locked = oks = fails = 0
    for rx, b0 in zip(rxs, base_cnt):
        n_l = sum(rx.locked(c) for c in range(channels_per))
        o = sum(rx.crc_counts(c)[0] for c in range(channels_per)) \
            - sum(x[0] for x in b0)
        f = sum(rx.crc_counts(c)[1] for c in range(channels_per)) \
            - sum(x[1] for x in b0)
        assert n_l > channels_per * 0.9, n_l
        assert o > 3 * f, (o, f)
        locked += n_l
        oks += o
        fails += f
    msps = processed / dt / 1e6
    rt = msps * 1e6 / (2 * fs)
    sw = np.asarray(sb_wall)
    sb_air = sb_adv / fs
    return dict(channels=2 * channels_per, t50=t50, k=k, dual=True,
                wideband_msps=round(msps, 1),
                rt_multiplexes=round(rt, 2),
                rt_channels=int(rt * 2 * channels_per),
                locked=locked, crc_ok=oks, crc_fail=fails,
                seconds_air=round(processed / (2 * fs), 2),
                wall=round(dt, 2),
                sb_air_ms=round(sb_air * 1e3, 1),
                sb_wall_ms=round(float(sw.mean()) * 1e3, 1),
                sb_wall_p95_ms=round(float(np.percentile(sw, 95)) * 1e3, 1),
                rt_margin=round(sb_air / float(sw.mean()), 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--t50", type=int, default=6400)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-fleet", action="store_true",
                    help="python bit pipeline (round-1 baseline path)")
    ap.add_argument("--k", type=int, default=4,
                    help="wideband superblock depth (cycles per device "
                         "dispatch+fetch)")
    ap.add_argument("--cs16", action="store_true",
                    help="feed SDR-native interleaved int16 (device-side "
                         "conversion; halves the host->device bytes)")
    ap.add_argument("--resident", action="store_true",
                    help="pre-stage the IQ windows in device memory and "
                         "feed via process_wideband_staged: measures the "
                         "device+host stack without the raw-IQ upload "
                         "(its bandwidth is reported separately)")
    ap.add_argument("--dual", action="store_true",
                    help="TWO resident receivers of --channels each, "
                         "round-robined on one device (see measure_dual)")
    ap.add_argument("--pipeline", action="store_true",
                    help="with --resident: double-buffered superblocks "
                         "(TetraReceiver(wb_pipeline=True)) so device "
                         "compute overlaps the host bit->MAC stack")
    args = ap.parse_args()

    from tetra_tpu import compile_cache, device_info
    compile_cache.enable()
    devs, card = device_info.require_gpu()
    from tetra_tpu.rx.receiver import TetraReceiver

    def run(channels, t50, fleet=True):
        wide = build_wideband(channels, args.seconds + 1.5)
        if args.cs16:
            inter = np.empty(2 * len(wide), np.int16)
            sc = 30000.0 / np.abs(wide).max()
            inter[0::2] = np.round(wide.real * sc)
            inter[1::2] = np.round(wide.imag * sc)
            wide = inter
        rx = TetraReceiver(wideband=channels, t50=t50, fleet=fleet,
                           events=False, wb_k=args.k)
        # warmup: compiles every program in the path AND covers the FLL
        # pull-in + scrambling acquisition (~1.5 s of air; the fused
        # wideband path has no per-channel coarse-CFO priming)
        stride = 2 if args.cs16 else 1
        adv = stride * rx._wb["advance"] * max(1, args.k)
        warm = stride * rx._wb["wide_len"] + adv
        rx.process_wideband(wide[:warm])
        used = warm
        fs = stride * channels * 25_000
        while used < int(1.5 * fs):
            rx.process_wideband(wide[used:used + adv])
            used += adv
        ok0 = sum(rx.crc_counts(c)[0] for c in range(channels))
        fail0 = sum(rx.crc_counts(c)[1] for c in range(channels))
        processed = 0
        t0 = time.perf_counter()
        while used + adv <= len(wide):
            rx.process_wideband(wide[used:used + adv])
            used += adv
            processed += adv
        dt = time.perf_counter() - t0
        n_locked = sum(rx.locked(c) for c in range(channels))
        oks = sum(rx.crc_counts(c)[0] for c in range(channels)) - ok0
        fails = sum(rx.crc_counts(c)[1] for c in range(channels)) - fail0
        msps = processed / stride / dt / 1e6
        rt = msps * 1e6 / (channels * 25_000)   # real-time multiplexes
        assert n_locked > channels * 0.9, f"only {n_locked} locked"
        # steady state must be CRC-clean-dominated (decode-level sanity)
        assert oks > 3 * fails, (oks, fails)
        return dict(channels=channels, t50=t50, fleet=fleet,
                    cs16=bool(args.cs16), k=args.k,
                    wideband_msps=round(msps, 1),
                    rt_multiplexes=round(rt, 2),
                    rt_channels=int(rt * channels),
                    locked=n_locked, crc_ok=oks, crc_fail=fails,
                    seconds_air=round(processed / (channels * 25_000), 2),
                    wall=round(dt, 2))

    device = dict(device=device_info.describe(devs), card=card)
    if args.sweep:
        for ch, t50 in ((64, 6400), (256, 6400), (256, 12800), (512, 6400)):
            print(json.dumps(dict(run(ch, t50), **device)), flush=True)
        return
    if args.dual:
        r = measure_dual(args.channels, args.t50, args.k, args.seconds)
    elif args.resident:
        r = measure_resident(args.channels, args.t50, args.k,
                             args.seconds, args.pipeline)
    else:
        r = run(args.channels, args.t50, fleet=not args.no_fleet)
    print(json.dumps(dict(r, **device)))


if __name__ == "__main__":
    main()
