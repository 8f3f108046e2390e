"""Demod-phase-only bench: the same program and dispatch flow as bench.py's
primary line (heterogeneous locked fleet, pipelined k-block scan dispatch),
without the e2e phase -- for iterating on the demod kernels without paying
the whole-receiver run.  Run alone (host contention skews timings).

Usage: python scripts/bench_demod.py [channels] [block] [k] [iters]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    channels = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 4608
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 6

    import jax
    import jax.numpy as jnp

    from bench import heterogeneous_fleet_iq
    from tetra_tpu.rx import demod_fast as demod_mod

    n_chunks = demod_mod.n_chunks_for(block)

    def body(state, xs):
        xr, xi = xs
        state, outs = demod_mod._demod_block_impl(
            state, xr, xi, n_chunks)
        # scalar checksum INSIDE the jit (an out-of-jit reduction would
        # compile a second program)
        return state, outs["dist"].sum()

    def step(state, xr_k, xi_k):
        state, sums = jax.lax.scan(body, state, (xr_k, xi_k))
        return state, sums.sum()

    jit_step = jax.jit(step)
    xr_h, xi_h = heterogeneous_fleet_iq(k, channels, block)
    xr = jnp.asarray(xr_h)
    xi = jnp.asarray(xi_h)
    del xr_h, xi_h
    state = demod_mod.demod_init(channels)
    t0 = time.perf_counter()
    state, chk = jit_step(state, xr, xi)
    float(chk)
    compile_s = time.perf_counter() - t0
    state, chk = jit_step(state, xr, xi)
    float(chk)
    t0 = time.perf_counter()
    chks = []
    for _ in range(iters):
        # pipelined dispatch as bench.py: issue all, fetch checksums last
        state, chk = jit_step(state, xr, xi)
        chks.append(chk)
    for c in chks:
        float(c)
    dt = time.perf_counter() - t0
    msps = k * channels * block * iters / dt / 1e6
    print(json.dumps({
        "channels": channels, "block": block, "k": k,
        "fll_decim": demod_mod.FLL_DECIM, "agc_rms": demod_mod.AGC_RMS,
        "compile_s": round(compile_s, 1),
        "ms_per_dispatch": round(dt / iters * 1e3, 1),
        "msps": round(msps, 1)}), flush=True)


if __name__ == "__main__":
    main()
