"""Per-stage attribution of the resident e2e superblock cycle.

Replays the exact production per-superblock flow of
TetraReceiver.process_wideband_staged + FleetEngine.process_packed2 with a
timer around each stage (dispatch, fetch, fleet feed, FEC, dispatch).  Run
alone on the accelerator host: one process per card.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from bench_e2e import build_wideband  # noqa: E402 (same dir)
    from tetra_tpu.rx import fec as rx_fec
    from tetra_tpu.rx.receiver import TetraReceiver, _wideband_step_scan

    channels, t50, K = 256, 6400, 16
    rx = TetraReceiver(wideband=channels, t50=t50, fleet=True, events=False,
                       wb_k=K)
    wb = rx._wb
    adv, wlen = wb["advance"], wb["wide_len"]
    sb_adv = K * adv
    wide = build_wideband(channels, 8.0)
    n_super = (len(wide) - wlen) // sb_adv
    staged = []
    for s in range(n_super):
        base = s * sb_adv
        wr = np.stack([wide[base + j * adv: base + j * adv + wlen].real
                       for j in range(K)]).astype(np.float32)
        wi = np.stack([wide[base + j * adv: base + j * adv + wlen].imag
                       for j in range(K)]).astype(np.float32)
        staged.append((jax.device_put(wr), jax.device_put(wi)))
    for w in staged:
        w[0].block_until_ready(), w[1].block_until_ready()

    # warm up through the normal path (compile + acquisition)
    warm = max(1, int(1.5 * channels * 25_000 / sb_adv) + 1)
    for s in range(warm):
        rx.process_wideband_staged(*staged[s])

    fleet = rx.fleet
    t = {}

    def lap(name, t0):
        t[name] = t.get(name, 0.0) + (time.perf_counter() - t0)
        return time.perf_counter()

    iters = 0
    for s in range(warm, n_super):
        wr, wi = staged[s]
        iters += 1
        t0 = time.perf_counter()
        (rx.state, fused, wb["hist_r"], wb["hist_i"]) = _wideband_step_scan(
            rx.state, wr, wi, wb["hist_r"], wb["hist_i"], channels,
            wb["t36"], wb["n_chunks"], False, K)
        t0 = lap("sb_dispatch", t0)
        arr = np.asarray(fused)
        t0 = lap("sb_fetch", t0)
        vcount = arr[-2].copy().view(np.float32)
        dsum = arr[-1].copy().view(np.float32)
        rx._apply_quality(vcount, dsum)
        words = arr[:-2]
        fleet._ensure_rowbufs(K, wb["n_chunks"] * 32)
        words = np.ascontiguousarray(words, np.int32)
        t0 = lap("host_prep", t0)
        n = int(fleet.lib.fleet_feed_sb(
            fleet.h, words.ctypes.data, K, wb["n_chunks"],
            fleet._t5.ctypes.data, fleet._meta.ctypes.data, fleet._cap))
        t0 = lap("fleet_feed_sb", t0)
        order = np.argsort(fleet._meta[:n, 0], kind="stable")
        fleet._t5[:n] = fleet._t5[:n][order]
        fleet._meta[:n] = fleet._meta[:n][order]
        meta = fleet._meta[:n]
        t5p = fleet._t5[:n]
        chans = meta[:, 0]
        blk_types = meta[:, 1]
        scrambs = fleet.scramb[chans]
        idx, okmap = fleet._ks_cycle_map(scrambs)
        t0 = lap("sort+ks", t0)
        assert okmap
        # local BBK rows (decoded natively at feed time) stay off the
        # device batch, exactly as FleetEngine._decode_dispatch
        local = (meta[:, 11] & 0x8000) != 0
        didx = np.nonzero(~local)[0]
        t5p_d, blk_d, idx_d = t5p[didx], blk_types[didx], idx[didx]
        t0 = lap("bbk_local_filter", t0)
        # FEC: dispatch vs fetch split.  Typed path (round 4, the
        # production default): SB1/NDB rows on the 144-step short program
        # (27-byte uploads, 17-byte result rows); SCH-F rows (if any) on
        # the full-width program.  Chunked over the fixed buckets exactly
        # as decode_rows_typed_packed.
        N = len(blk_d)
        tsel = rx_fec._MIX_TSEL_OF[np.asarray(blk_d, np.int64)]
        idx2 = np.where(blk_d == 0, 0, idx_d).astype(np.int32)
        t5p = t5p_d
        out = np.zeros((N, 35), np.uint8)
        si = np.nonzero((tsel == rx_fec._MIX_SB1)
                        | (tsel == rx_fec._MIX_NDB))[0]
        fi = np.nonzero(tsel == rx_fec._MIX_SCHF)[0]
        t0 = lap("fec_partition", t0)
        bucket = fleet.short_bucket or fleet.pad_rows
        for s0 in range(0, len(si), bucket):
            rows = si[s0:s0 + bucket]
            pad = bucket - len(rows)
            tc = np.concatenate([np.ascontiguousarray(t5p[rows, :27]),
                                 np.zeros((pad, 27), np.uint8)])
            ic = np.concatenate([idx2[rows], np.zeros(pad, np.int32)])
            sc = np.concatenate([tsel[rows], np.zeros(pad, np.int32)])
            t0 = lap("fec_pad", t0)
            out_dev = rx_fec._decode_short_packed_jit(
                jnp.asarray(tc), fleet._ks_dev, jnp.asarray(ic),
                jnp.asarray(sc))
            t0 = lap("fec_dispatch", t0)
            r = np.asarray(out_dev)
            out[rows, :16] = r[:len(rows), :16]
            out[rows, 34] = r[:len(rows), 16]
            t0 = lap("fec_fetch", t0)
        fbucket = fleet.schf_bucket or max(512, (fleet.pad_rows or 0) // 2)
        for s0 in range(0, len(fi), fbucket):
            rows = fi[s0:s0 + fbucket]
            pad = fbucket - len(rows)
            tc = np.concatenate([t5p[rows], np.zeros((pad, 54), np.uint8)])
            ic = np.concatenate([idx2[rows], np.zeros(pad, np.int32)])
            t0 = lap("fec_pad", t0)
            out_dev = rx_fec._decode_schf_packed_jit(
                jnp.asarray(tc), fleet._ks_dev, jnp.asarray(ic))
            t0 = lap("fec_dispatch_schf", t0)
            out[rows] = np.asarray(out_dev)[:len(rows)]
            t0 = lap("fec_fetch_schf", t0)
        type1p = np.zeros((n, 34), np.uint8)
        ok = np.zeros(n, np.uint8)
        type1p[didx] = out[:N, :34]
        ok[didx] = out[:N, 34]
        lrows = np.nonzero(local)[0]
        vals = meta[lrows, 11]
        info = (vals & 0x3FFF).astype(np.int64)
        type1p[lrows, 0] = (info >> 6).astype(np.uint8)
        type1p[lrows, 1] = ((info & 63) << 2).astype(np.uint8)
        ok[lrows] = ((vals >> 14) & 1).astype(np.uint8)
        type1p = np.ascontiguousarray(type1p)
        t0 = lap("merge_local", t0)
        actions = np.empty(n, np.uint8)
        times_ = np.empty((n, 5), np.int64)
        fleet.lib.fleet_dispatch(fleet.h, type1p.ctypes.data, ok.ctypes.data,
                                 meta.ctypes.data, n, 0, 0,
                                 actions.ctypes.data, times_.ctypes.data)
        t0 = lap("fleet_dispatch", t0)
    rec = {k: round(v / iters * 1000, 1) for k, v in t.items()}
    rec["iters"] = iters
    rec["rows_per_super"] = int(n)
    rec["bucket"] = int(fleet.pad_rows)
    rec["total_ms"] = round(sum(v for k, v in rec.items()
                                if isinstance(v, float)), 1)
    print(json.dumps(rec))
    with open("/tmp/attr_e2e.json", "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
