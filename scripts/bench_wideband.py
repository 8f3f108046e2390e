"""Wideband device probe: channelizer -> resampler -> demod in one program.

Measures sustained wideband IQ throughput (raw antenna samples/s) for the
full front-end + demod cascade on one GPU: polyphase channelize n_ch x
25 kHz (slice/matmul framing), 18/25 banded-matmul resample, chunked demod.
Same bulk-scan dispatch pattern as bench.py.  Prints one JSON line.

Usage: python scripts/bench_wideband.py [n_ch t50 k G]
"""

import json
import sys
import time

import numpy as np


def main():
    from tetra_tpu import compile_cache, device_info
    compile_cache.enable()
    devs, card = device_info.require_gpu()
    import jax
    import jax.numpy as jnp

    from tetra_tpu.parallel import channelizer as CH
    from tetra_tpu.rx import demod_fast as demod_mod

    def run_config(n_ch, t50, k, G=1):
        """G: independent n_ch-channel multiplexes stacked per scan block
        (channelized per stream, demodulated together at C=G*n_ch): a
        fixed per-dispatch overhead amortizes over k*G blocks."""
        hop = n_ch // 2
        L = n_ch * CH.TAPS_PER_BRANCH
        t36 = t50 * 18 // 25
        assert t50 % 25 == 0 and t36 % demod_mod.K_SAMP == 0
        wide_len = (t50 - 1) * hop + L
        advance = t50 * hop
        n_chunks = demod_mod.n_chunks_for(t36)
        # front-end per mux (CH._front_end_block), then the demod at
        # C = G*n_ch
        import functools
        fe = functools.partial(CH._front_end_block, n_ch=n_ch, t36=t36)
        fe_g = jax.vmap(lambda r, i, hr, hi: fe(r, i, hr, hi))

        def body(carry, xs):
            dstate, hr, hi = carry           # hists: (G, pad, n_ch)
            wr, wi = xs                      # (G, wide_len)
            rr, ri, hr, hi = fe_g(wr, wi, hr, hi)   # (G, t36, n_ch)
            rr = jnp.moveaxis(rr, 0, 1).reshape(t36, G * n_ch)
            ri = jnp.moveaxis(ri, 0, 1).reshape(t36, G * n_ch)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr.T, ri.T, n_chunks)
            return (dstate, hr, hi), outs["dist"].sum()

        def step(carry, wr_k, wi_k):
            carry, sums = jax.lax.scan(body, carry, (wr_k, wi_k))
            return carry, sums.sum()

        jit_step = jax.jit(step)
        rng = np.random.default_rng(0)
        wr = jnp.asarray(
            rng.standard_normal((k, G, wide_len)).astype(np.float32))
        wi = jnp.asarray(
            rng.standard_normal((k, G, wide_len)).astype(np.float32))
        hist = jnp.zeros((G, CH.RS_TAPS_PER_PHASE - 1, n_ch), jnp.float32)
        carry = (demod_mod.demod_init(G * n_ch), hist, hist)
        carry, chk = jit_step(carry, wr, wi)
        float(chk)
        carry, chk = jit_step(carry, wr, wi)
        float(chk)
        iters = 6
        t0 = time.perf_counter()
        # pipelined dispatch (see bench.py): fixed per-call host overhead
        # overlaps device compute; final fetches force full execution
        chks = []
        for _ in range(iters):
            carry, chk = jit_step(carry, wr, wi)
            chks.append(chk)
        for c in chks:
            float(c)
        dt = time.perf_counter() - t0
        return G * k * advance * iters / dt / 1e6

    # t50 must map to a K_SAMP-multiple t36 (t50 * 18/25 % K_SAMP == 0)
    n_ch, t50, k, G = (int(a) for a in (sys.argv[1:] or [256, 6400, 8, 1]))
    msps = run_config(n_ch, t50, k, G)
    # wideband Msamples/s at n_ch*25 kHz == n_ch/40 real-time multiplexes
    print(json.dumps({
        "metric": "wideband_frontend_throughput",
        "value": msps,
        "unit": "wideband Msamples/s",
        "config": dict(n_ch=n_ch, t50=t50, k=k, G=G),
        "realtime_multiplexes": msps * 1e6 / (n_ch * 25_000) * G,
        "device": device_info.describe(devs), "card": card,
    }))


if __name__ == "__main__":
    main()
