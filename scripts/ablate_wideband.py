"""Wideband-cascade component attribution on the accelerator.

Times the pieces of the fused cascade (bench_wideband.py) separately --
channelizer front end, resampler, demod -- and a G-stacked variant (G
independent 256-channel multiplexes channelized per stream, demodulated
together at C=G*256) to attribute where a cycle's time goes.

Modes (argv[1]): chonly | full | stacked
  chonly:  channelize + resample only (checksum on resampled stream)
  full:    the bench_wideband body (per-mux program, C=n_ch)
  stacked: G muxes per program; demod at C=G*n_ch
argv: mode [n_ch] [t50] [k] [G]
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from tetra_tpu.parallel import channelizer as CH
    from tetra_tpu.rx import demod_fast as demod_mod

    mode = sys.argv[1] if len(sys.argv) > 1 else "stacked"
    n_ch = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    t50 = int(sys.argv[3]) if len(sys.argv) > 3 else 6400
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    G = int(sys.argv[5]) if len(sys.argv) > 5 else 8

    hop = n_ch // 2
    L = n_ch * CH.TAPS_PER_BRANCH
    t36 = t50 * 18 // 25
    assert t50 % 25 == 0 and t36 % demod_mod.K_SAMP == 0
    wide_len = (t50 - 1) * hop + L
    advance = t50 * hop
    n_chunks = demod_mod.n_chunks_for(t36)

    if mode == "foldonly":   # polyphase fold only (no DFT): the 96-slice
        import jax.numpy as jnp2

        def body(carry, xs):
            wr, wi = xs
            hop_ = n_ch // 2
            h2 = CH._prototype(n_ch).reshape(CH.TAPS_PER_BRANCH, 2, hop_)
            T = wr.shape[0]
            n_out = (T - L) // hop_ + 1
            n_z = T // hop_
            zr = wr[:n_z * hop_].reshape(n_z, hop_)
            zi = wi[:n_z * hop_].reshape(n_z, hop_)
            acc = [[jnp2.zeros((n_out, hop_), wr.dtype) for _ in range(2)]
                   for _ in range(2)]
            for s in range(2 * CH.TAPS_PER_BRANCH):
                j, d = s // 2, s % 2
                w = jnp2.asarray(h2[j, d])
                acc[0][d] = acc[0][d] + zr[s:s + n_out] * w
                acc[1][d] = acc[1][d] + zi[s:s + n_out] * w
            fr = jnp2.concatenate(acc[0], axis=-1)
            fi = jnp2.concatenate(acc[1], axis=-1)
            return carry, fr.sum() + fi.sum()
        carry0 = jnp.zeros((), jnp.float32)
        xs_shape = (k, wide_len)
        muxes = 1
    elif mode == "dftonly":  # DFT + signflip + transpose on random frames
        Wr, Wi = map(jnp.asarray, CH._dft_basis(n_ch))

        def body(carry, xs):
            fr, fi = xs
            yr = fr @ Wr.T - fi @ Wi.T
            yi = fr @ Wi.T + fi @ Wr.T
            m = jnp.arange(fr.shape[0])
            kk = jnp.arange(n_ch)
            signflip = jnp.where((m[:, None] * kk[None, :]) % 2 == 1,
                                 -1.0, 1.0)
            yr = yr * signflip
            yi = yi * signflip
            return carry, (jnp.swapaxes(yr, 0, 1).sum()
                           + jnp.swapaxes(yi, 0, 1).sum())
        carry0 = jnp.zeros((), jnp.float32)
        xs_shape = (k, t50, n_ch)
        muxes = 1
    elif mode == "chanonly":   # channelize only (no resample)
        def body(carry, xs):
            wr, wi = xs
            yr, yi = CH._channelize_block(wr, wi, n_ch)
            return carry, yr.sum() + yi.sum()
        carry0 = jnp.zeros((), jnp.float32)
        xs_shape = (k, wide_len)
        muxes = 1
    elif mode == "resonly":  # resample only (fed channel-rate noise)
        def body(carry, xs):
            hr, hi = carry
            rr2, ri2 = xs
            rr, ri, hr, hi = CH._resample_stream_block(rr2, ri2, hr, hi, t36)
            return (hr, hi), rr.sum() + ri.sum()
        hist = jnp.zeros((n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
        carry0 = (hist, hist)
        xs_shape = (k, n_ch, t50)
        muxes = 1
    elif mode == "chonly":
        def body(carry, xs):
            hr, hi = carry
            wr, wi = xs
            yr, yi = CH._channelize_block(wr, wi, n_ch)
            rr, ri, hr, hi = CH._resample_stream_block(yr, yi, hr, hi, t36)
            return (hr, hi), rr.sum() + ri.sum()
        hist = jnp.zeros((n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
        carry0 = (hist, hist)
        xs_shape = (k, wide_len)
        muxes = 1
    elif mode == "full":
        def body(carry, xs):
            dstate, hr, hi = carry
            wr, wi = xs
            yr, yi = CH._channelize_block(wr, wi, n_ch)
            rr, ri, hr, hi = CH._resample_stream_block(yr, yi, hr, hi, t36)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr, ri, n_chunks)
            return (dstate, hr, hi), outs["dist"].sum()
        hist = jnp.zeros((n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
        carry0 = (demod_mod.demod_init(n_ch), hist, hist)
        xs_shape = (k, wide_len)
        muxes = 1
    elif mode == "stacked_fm":
        # frame-major cascade: channelizer emits (t50, n_ch), the superblock
        # left-matmul resampler keeps channels on lanes, one transpose feeds
        # the demod
        chan_g = jax.vmap(lambda r, i: CH._channelize_block_fm(r, i, n_ch))

        def body(carry, xs):
            dstate, hr, hi = carry
            wr, wi = xs                      # (G, wide_len)
            yr, yi = chan_g(wr, wi)          # (G, t50, n_ch)
            yr = jnp.moveaxis(yr, 0, 1).reshape(t50, G * n_ch)
            yi = jnp.moveaxis(yi, 0, 1).reshape(t50, G * n_ch)
            rr, ri, hr, hi = CH._resample_stream_block_fm(yr, yi, hr, hi,
                                                          t36)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr.T, ri.T, n_chunks)
            return (dstate, hr, hi), outs["dist"].sum()
        hist = jnp.zeros((CH.RS_TAPS_PER_PHASE - 1, G * n_ch), jnp.float32)
        carry0 = (demod_mod.demod_init(G * n_ch), hist, hist)
        xs_shape = (k, G, wide_len)
        muxes = G
    else:  # stacked
        chan_g = jax.vmap(lambda r, i: CH._channelize_block(r, i, n_ch))

        def body(carry, xs):
            dstate, hr, hi = carry
            wr, wi = xs                      # (G, wide_len)
            yr, yi = chan_g(wr, wi)          # (G, n_ch, t50)
            yr = yr.reshape(G * n_ch, t50)
            yi = yi.reshape(G * n_ch, t50)
            rr, ri, hr, hi = CH._resample_stream_block(yr, yi, hr, hi, t36)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr, ri, n_chunks)
            return (dstate, hr, hi), outs["dist"].sum()
        hist = jnp.zeros((G * n_ch, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
        carry0 = (demod_mod.demod_init(G * n_ch), hist, hist)
        xs_shape = (k, G, wide_len)
        muxes = G

    def step(carry, wr_k, wi_k):
        carry, sums = jax.lax.scan(body, carry, (wr_k, wi_k))
        return carry, sums.sum()

    jit_step = jax.jit(step)
    rng = np.random.default_rng(0)
    wr = jnp.asarray(rng.standard_normal(xs_shape).astype(np.float32))
    wi = jnp.asarray(rng.standard_normal(xs_shape).astype(np.float32))
    carry, chk = jit_step(carry0, wr, wi)
    float(chk)
    carry, chk = jit_step(carry, wr, wi)
    float(chk)
    iters = 6
    t0 = time.perf_counter()
    if "--pipelined" in sys.argv:
        chks = []
        for _ in range(iters):
            carry, chk = jit_step(carry, wr, wi)
            chks.append(chk)
        for c in chks:
            float(c)
    else:  # per-iter sync fetch: isolates per-dispatch fixed overhead
        for _ in range(iters):
            carry, chk = jit_step(carry, wr, wi)
            float(chk)
    dt = time.perf_counter() - t0
    msps = muxes * k * advance * iters / dt / 1e6
    print(json.dumps({
        "mode": mode, "n_ch": n_ch, "t50": t50, "k": k, "G": muxes,
        "wideband_msps": round(msps, 1),
        "ms_per_step": round(dt / iters * 1000, 1),
        "realtime_multiplexes": round(msps * 1e6 / (n_ch * 25_000), 1),
    }))


if __name__ == "__main__":
    main()
