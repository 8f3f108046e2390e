"""Native worker-pool timing: the pool DOING WORK, not just bit-exactness.

Times FleetEngine.process_packed2 (the production superblock feed:
fleet_feed_sb + device FEC + batched MAC dispatch) at threads=1 vs
threads=N on identical input, fresh engines per config, and prints one
JSON line with the wall-time ratio and host core count.  On a 2-core host
the pool auto-default stays sequential (cores-1 = 1); this script FORCES
thread counts to show the pool at least breaks even oversubscribed and
scales where cores exist.

Usage: python scripts/bench_pool.py [channels] [K] [iters] [threads...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_feed(C: int, K: int, n_chunks: int):
    """(K*G, C) int32 pack_cycle_tc words + a channel-major warm cycle.

    The packed layout comes from the CANONICAL producer
    (rx.receiver.pack_cycle_tc, on the CPU backend) rather than a third
    hand-rolled copy -- a layout change cannot silently desynchronize
    this bench (the independent host ORACLE packer stays in
    tests/test_fleet._pack2_host, where independence is the point)."""
    import jax.numpy as jnp

    from tetra_tpu.rx.receiver import pack_cycle_tc
    from tetra_tpu.rx.tdma import TdmaTime
    from tetra_tpu.tx import cell

    T = n_chunks * 32
    need = (K + 1) * T
    bits, _ = cell.downlink_bits(
        cell.CellConfig(mcc=262, mnc=90, cc=5), 2 * need // 255 + 4,
        start=TdmaTime(mn=1, fn=17, tn=4))
    dib = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)[:need]
    # per-channel roll so burst boundaries land at different ring offsets
    # (uneven per-channel work, like a real fleet)
    dibm = np.stack([np.roll(dib, 7 * c) for c in range(C)])
    warm = (dibm[:, :T] & 3) | 0x80
    rest = dibm[:, T:]
    rows = []
    ones = jnp.ones((T, C), jnp.int32)
    for j in range(K):
        d_tc = jnp.asarray(rest[:, j * T:(j + 1) * T].T.astype(np.int32))
        packed, _, _ = pack_cycle_tc(d_tc, ones, d_tc.astype(jnp.float32),
                                     C, n_chunks)
        rows.append(np.asarray(packed))
    return warm, np.concatenate(rows).astype(np.int32)


def run_config(C, K, n_chunks, warm, words, threads, iters):
    from tetra_tpu.rx.fleet import FleetEngine

    eng = FleetEngine(C, threads=threads)
    eng.process_packed(warm)                 # lock + compile warm-up
    eng.process_packed2(words, K, n_chunks)  # FEC program warm-up
    t0 = time.perf_counter()
    blocks = 0
    for _ in range(iters):
        blocks += eng.process_packed2(words, K, n_chunks)
    dt = (time.perf_counter() - t0) / iters
    ok = fail = 0
    for c in range(C):
        o, f = eng.crc_counts(c)
        ok += o
        fail += f
    return dt, blocks, ok, fail


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")  # host-pool bench: CPU FEC
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    threads = [int(t) for t in sys.argv[4:]] or [1, 2, 4]
    n_chunks = 74                     # even: production pairing geometry
    warm, words = make_feed(C, K, n_chunks)
    base = None
    out = {"channels": C, "K": K, "iters": iters,
           "cores": os.cpu_count(), "configs": {}}
    ref = None
    for t in threads:
        dt, blocks, ok, fail = run_config(C, K, n_chunks, warm, words, t,
                                          iters)
        row = {"ms_per_call": round(dt * 1e3, 1), "blocks": blocks,
               "crc_ok": ok, "crc_fail": fail}
        if base is None:
            base = dt
            ref = (blocks, ok, fail)
        else:
            row["speedup_vs_t1"] = round(base / dt, 2)
            assert (blocks, ok, fail) == ref, "thread count changed decode!"
        out["configs"][f"threads={t}"] = row
        print(json.dumps({f"threads={t}": row}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
