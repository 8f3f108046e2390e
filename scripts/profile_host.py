"""Profile the host bit->MAC stack (burst sync -> batched FEC -> dispatch).

Feeds N channels of synthesized downlink bits (no demod) through the same
path the receiver uses: BurstSync.feed per channel, then
process_bursts_multi (one batched device FEC call per block type + host
PDU dispatch).  Reports wall time per stage and the aggregate real-time
channel capacity of this host; optional cProfile top list.

Usage: python scripts/profile_host.py [n_ch] [n_slots] [--cprofile]
Runs on CPU jax (forced in-process) unless --device -- device FEC time
here is CPU-XLA; rx/hostpool + the accelerator carry that in production.
"""

import sys
import time

import numpy as np


def main():
    n_ch = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_slots = int(sys.argv[2]) if len(sys.argv) > 2 else 360
    use_cprofile = "--cprofile" in sys.argv

    import jax
    if "--device" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from tetra_tpu import params as P
    from tetra_tpu.rx.burst_sync import BurstSync
    from tetra_tpu.rx.lower_mac import LowerMac, process_bursts_multi
    from tetra_tpu.tx.cell import CellConfig, downlink_bits

    cfg = CellConfig()
    bits, _ = downlink_bits(cfg, n_slots)
    streams = [bits for _ in range(n_ch)]   # identical cells: worst host case
    syncs = [BurstSync() for _ in range(n_ch)]
    macs = [LowerMac() for _ in range(n_ch)]
    if "--events" not in sys.argv:   # production default: no event log
        for m in macs:
            m.upper.events_enabled = False

    block_bits = 4608
    n_blocks = len(bits) // block_bits

    t_sync = t_mac = 0.0
    n_bursts = 0

    def run():
        nonlocal t_sync, t_mac, n_bursts
        for b in range(n_blocks):
            t0 = time.perf_counter()
            bursts_list = []
            for c in range(n_ch):
                chunk = streams[c][b * block_bits:(b + 1) * block_bits]
                bursts_list.append(syncs[c].feed(chunk))
            t1 = time.perf_counter()
            process_bursts_multi(macs, bursts_list)
            t2 = time.perf_counter()
            t_sync += t1 - t0
            t_mac += t2 - t1
            n_bursts += sum(len(b) for b in bursts_list)

    if use_cprofile:
        import cProfile
        import pstats
        pr = cProfile.Profile()
        pr.enable()
        run()
        pr.disable()
        stats = pstats.Stats(pr)
        stats.sort_stats("cumulative").print_stats(28)
    else:
        run()

    wall = t_sync + t_mac
    seconds_of_air = n_blocks * block_bits / 36000.0  # 36 kbit/s per channel
    rt = n_ch * seconds_of_air / wall
    crc_ok = sum(m.crc_oks for m in macs)
    crc_fail = sum(m.crc_fails for m in macs)
    print({"n_ch": n_ch, "blocks": n_blocks, "bursts": n_bursts,
           "crc_ok": crc_ok, "crc_fail": crc_fail,
           "t_sync_s": round(t_sync, 2), "t_mac_s": round(t_mac, 2),
           "air_s": round(seconds_of_air, 2),
           "realtime_channels": round(rt, 1)})


if __name__ == "__main__":
    main()
