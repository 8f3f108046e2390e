"""Ablation of the superblock device program and the FEC programs.

Measures, on the accelerator at the production shape (C=256, t50=6400,
K=16):

  sb_full   new time-major nibble-packed superblock, full output fetch
  sb_sum    same program but returning only a checksum (compute, no fetch)
  sb_noout  front-end + demod only, dist sums (the bench_wideband floor)
  fec_mixed single mixed program @ 131072 rows (r2 baseline shape,
            round-3 gather-free Viterbi), checksum only
  fec_cch   split CCH program @ the receiver's steady-state bucket
  fec_bbk   split BBK (RM-only) program @ its bucket

Each variant is ONE compiled program; timings use warm iterations with a
forced scalar fetch.  Results
append to /tmp/ablate_superblock.jsonl and print as JSON lines.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "/tmp/ablate_superblock.jsonl"


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main():
    import jax
    import jax.numpy as jnp

    from tetra_tpu.parallel import channelizer as CH
    from tetra_tpu.rx import demod_fast as DF
    from tetra_tpu.rx import fec as rx_fec
    from tetra_tpu.rx.receiver import _wideband_step_scan
    from tetra_tpu import params as P

    C, t50, K = 256, 6400, 16
    t36 = t50 * 18 // 25
    hop = C // 2
    L = C * CH.TAPS_PER_BRANCH
    wide_len = (t50 - 1) * hop + L
    n_chunks = DF.n_chunks_for(t36)
    pad = CH.RS_TAPS_PER_PHASE - 1

    rng = np.random.default_rng(0)
    wr = jnp.asarray(rng.standard_normal((K, wide_len)).astype(np.float32))
    wi = jnp.asarray(rng.standard_normal((K, wide_len)).astype(np.float32))
    hist = jnp.zeros((pad, C), jnp.float32)
    state0 = DF.demod_init(C)

    def timeit(name, call, fetch, iters=5, extra=None):
        t0 = time.perf_counter()
        r = call()
        fetch(r)
        compile_s = time.perf_counter() - t0
        for _ in range(2):
            fetch(call())
        t0 = time.perf_counter()
        for _ in range(iters):
            r = call()
            fetch(r)
        dt = (time.perf_counter() - t0) / iters
        rec = dict(name=name, sec_per_call=round(dt, 4),
                   ms_per_cycle=round(dt / K * 1000, 2),
                   compile_s=round(compile_s, 1))
        if extra:
            rec.update(extra)
        emit(rec)
        return dt

    # ---- superblock variants ----------------------------------------------
    def sb_full():
        _, out, _, _ = _wideband_step_scan(state0, wr, wi, hist, hist, C,
                                           t36, n_chunks, False, K)
        return out

    g_rows = 2 * n_chunks + -(-n_chunks // 4)   # pack_cycle_tc rows/cycle
    timeit("sb_full", sb_full, lambda r: np.asarray(r),
           extra=dict(fetch_mb=round((K * g_rows + 2) * C * 4 / 1e6, 2)))

    import functools

    @jax.jit
    def _sb_sum(state, wr, wi, hr, hi):
        _, out, _, _ = _wideband_step_scan(state, wr, wi, hr, hi, C, t36,
                                           n_chunks, False, K)
        return jnp.sum(out, dtype=jnp.int32)

    timeit("sb_sum", lambda: _sb_sum(state0, wr, wi, hist, hist),
           lambda r: int(r))

    @jax.jit
    def _sb_noout(state, wr, wi, hr, hi):
        def body(carry, xs):
            st, hr, hi = carry
            xr, xi = xs
            rr, ri, hr, hi = CH._front_end_block(xr, xi, hr, hi, C, t36)
            st, outs = DF._demod_block_impl(st, rr.T, ri.T, n_chunks)
            return (st, hr, hi), jnp.sum(outs["dist"])
        (_, _, _), sums = jax.lax.scan(body, (state, hr, hi), (wr, wi))
        return sums.sum()

    timeit("sb_noout", lambda: _sb_noout(state0, wr, wi, hist, hist),
           lambda r: float(r))

    # ---- FEC variants ------------------------------------------------------
    slots = t36 / 510.0
    cch_bucket = -(-int(C * K * slots * 1.6) // 1024) * 1024
    bbk_bucket = -(-int(C * K * slots * 1.25) // 1024) * 1024
    B_mixed = 131072

    ks_host = np.zeros((16, 432), np.uint8)
    ks_host[0] = rx_fec.keystream(P.SCRAMB_INIT, 432)
    ks_host[1] = rx_fec.keystream(P.scramb_get_init(262, 1234, 7), 432)
    ks_dev = jnp.asarray(ks_host)

    def rows(B, bbk_frac):
        t5p = rng.integers(0, 256, (B, 54), dtype=np.int64).astype(np.uint8)
        tsel = np.where(rng.random(B) < bbk_frac, 3,
                        rng.integers(0, 3, B)).astype(np.int32)
        idx = rng.integers(0, 2, B).astype(np.int32)
        return (jnp.asarray(t5p), jnp.asarray(idx), jnp.asarray(tsel))

    t5m, idxm, tselm = rows(B_mixed, 0.45)

    @jax.jit
    def _fec_mixed_sum(t5p, idx, tsel):
        return jnp.sum(rx_fec._decode_mixed_packed_jit(t5p, ks_dev, idx,
                                                       tsel),
                       dtype=jnp.int32)

    timeit("fec_mixed", lambda: _fec_mixed_sum(t5m, idxm, tselm),
           lambda r: int(r), extra=dict(rows=B_mixed))

    t5c, idxc, tselc = rows(cch_bucket, 0.0)
    tselc = jnp.minimum(tselc, 2)

    @jax.jit
    def _fec_cch_sum(t5p, idx, tsel):
        return jnp.sum(rx_fec._decode_cch_packed_jit(t5p, ks_dev, idx,
                                                     tsel),
                       dtype=jnp.int32)

    timeit("fec_cch", lambda: _fec_cch_sum(t5c, idxc, tselc),
           lambda r: int(r), extra=dict(rows=cch_bucket))

    t5b = jnp.asarray(np.asarray(t5c[:bbk_bucket, :4]))
    idxb = idxc[:bbk_bucket]

    @jax.jit
    def _fec_bbk_sum(t5p4, idx):
        return jnp.sum(rx_fec._decode_bbk_packed_jit(t5p4, ks_dev, idx),
                       dtype=jnp.int32)

    timeit("fec_bbk", lambda: _fec_bbk_sum(t5b, idxb),
           lambda r: int(r), extra=dict(rows=bbk_bucket))


if __name__ == "__main__":
    main()
