"""Accelerator throughput of the feedforward block receiver (rx/demod_ff),
to compare with the chunked chain of bench.py's demod line.

Same methodology as bench.py: locked TETRA downlink input, (C, T) blocks,
k blocks scanned per dispatch, checksum folded into the jitted program,
scalar fetch to defeat async dispatch.  Prints one JSON line.

Usage: python scripts/bench_ff.py [C] [T] [k]
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from bench import locked_downlink_iq
    from tetra_tpu.rx import demod_ff as FF

    C = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 4608
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 32

    def body(state, xs):
        state, outs = FF._demod_block_impl(state, xs[0], xs[1])
        return state, outs["dist"].sum()

    @jax.jit
    def run(state, xr_k, xi_k):
        state, sums = jax.lax.scan(body, state, (xr_k, xi_k))
        return state, sums.sum()

    iq = locked_downlink_iq(k * T + 2)
    xr = np.empty((k, C, T), np.float32)
    xi = np.empty((k, C, T), np.float32)
    for j in range(k):
        seg = iq[j * T:(j + 1) * T]
        xr[j] = np.broadcast_to(seg.real, (C, T))
        xi[j] = np.broadcast_to(seg.imag, (C, T))
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    state = FF.demod_init(C)

    state, s0 = run(state, xr, xi)          # compile + warm
    float(s0)
    t0 = time.perf_counter()
    n_iter = 3
    for _ in range(n_iter):
        state, sv = run(state, xr, xi)
        float(sv)
    dt = (time.perf_counter() - t0) / n_iter
    msps = C * T * k / dt / 1e6
    print(json.dumps({
        "metric": "ff_demod_chain_throughput", "value": round(msps, 1),
        "unit": "Msamples/s/chip", "config": {"C": C, "T": T, "k": k},
        "sec_per_dispatch": round(dt, 3),
        "vs_baseline": round(msps / 0.036, 1)}))


if __name__ == "__main__":
    main()
