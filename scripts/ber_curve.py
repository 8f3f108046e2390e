"""BER-vs-SNR curves for the narrowband and wideband (channelizer) paths.

For each SNR: run the full modem over a synthetic cell (240 slots, CFO),
match every received burst to its TX slot by TDMA time, and report

  * lock         - receiver reached RX_LOCKED
  * pre-FEC BER  - raw 510-bit slot errors vs TX ground truth, counted only
                   AFTER the first SYNC-PDU time resync (slots demodulated
                   during the FLL pull-in carry provisional TDMA stamps and
                   unconverged-loop bit errors by design)
  * CRC-ok rate  - decoded control blocks passing CRC over the same window

Usage: JAX_PLATFORMS=cpu python scripts/ber_curve.py
(CPU is fine: this is a quality sweep, not a throughput bench).
"""

import sys

import numpy as np


def run_point(snr_db, cfo_hz, wideband=False, n_slots=240, seed=7,
              fused=False):
    import jax
    import jax.numpy as jnp

    from tetra_tpu import params as P
    from tetra_tpu.parallel import channelizer as CH
    from tetra_tpu.rx.burst_sync import RX_LOCKED
    from tetra_tpu.rx.receiver import TetraReceiver
    from tetra_tpu.rx.tdma import TdmaTime
    from tetra_tpu.tx import cell
    from tetra_tpu.tx.channel import channel
    from tetra_tpu.tx.modulator import modulate
    from tetra_tpu.tx.wideband import assemble_wideband

    cfg = cell.CellConfig()
    bits, records = cell.downlink_bits(cfg, n_slots,
                                       start=TdmaTime(mn=1, fn=17, tn=4))
    x = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
    if wideband:
        N, k = 16, 5
        wide = assemble_wideband({k: x}, N, amplitude=0.5)
        wide = np.asarray(channel(
            jnp.asarray(wide[None]), jax.random.key(seed),
            snr_db=snr_db - 10 * np.log10(N / 2), cfo_hz=cfo_hz,
            sample_rate=N * 25_000.0))[0]
        if fused:
            # the production fused cascade (TetraReceiver.process_wideband)
            ch_idx = k
            rx = TetraReceiver(wideband=N, t50=1600)
            y = None
        else:
            y = CH.resample_50_to_36(CH.channelize(wide, N))[k][None]
            ch_idx = 0
            rx = TetraReceiver(1)
    else:
        y = np.asarray(channel(jnp.asarray(x[None]), jax.random.key(seed),
                               snr_db=snr_db, cfo_hz=cfo_hz,
                               sample_rate=P.SAMPLE_RATE))
        ch_idx = 0
        rx = TetraReceiver(1)

    got = []
    crc0 = [0, 0]
    m = rx.mac[ch_idx]
    orig = m._dispatch_decoded

    def spy(items, decoded, bursts):
        synced = m.cell.mcc == cfg.mcc   # first SB1 adopted -> times valid
        if not synced:
            crc0[0], crc0[1] = m.crc_oks, m.crc_fails  # pre-sync tallies
        got.extend((synced, b) for b in bursts)
        return orig(items, decoded, bursts)

    m._dispatch_decoded = spy
    if y is None:
        step = 123_457   # deliberately unaligned raw feeds
        for i in range(0, len(wide), step):
            rx.process_wideband(wide[i:i + step])
    else:
        T = 4096
        for i in range(y.shape[1] // T):
            rx.process(y[:, i * T:(i + 1) * T])

    tx_by_time = {(r.time.mn, r.time.fn, r.time.tn): i
                  for i, r in enumerate(records)}
    nbits = nerr = matched = 0
    for synced, b in got:
        if not synced:
            continue
        key = (b.time.mn, b.time.fn, b.time.tn)
        if key not in tx_by_time:
            continue
        s = tx_by_time[key]
        tx_slot = bits[s * 510:(s + 1) * 510]
        nerr += int((b.bits != tx_slot).sum())
        nbits += 510
        matched += 1
    oks = m.crc_oks - crc0[0]
    fails = m.crc_fails - crc0[1]
    return dict(
        locked=rx.sync[ch_idx].state == RX_LOCKED,
        matched_slots=matched,
        ber=(nerr / nbits) if nbits else float("nan"),
        crc_ok_rate=(oks / (oks + fails)) if oks + fails else 0.0,
    )


def main():
    print(f"{'path':<10} {'SNR dB':>6} {'lock':>5} {'slots':>5} "
          f"{'pre-FEC BER':>12} {'CRC-ok':>7}")
    for wideband, fused in ((False, False), (True, False), (True, True)):
        name = ("wb-fused" if fused else "wideband") if wideband else "narrow"
        for snr in (8, 10, 12, 14, 16, 18, 20, 25):
            r = run_point(float(snr), 300.0, wideband=wideband, fused=fused)
            ber = ("-" if r["ber"] != r["ber"] or r["matched_slots"] == 0
                   else f"{r['ber']:.2e}")
            print(f"{name:<10} {snr:>6} {str(r['locked']):>5} "
                  f"{r['matched_slots']:>5} {ber:>12} "
                  f"{r['crc_ok_rate']:>7.2%}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
