"""Stage attribution for the feedforward chain on the accelerator.

Variants build successive prefixes of the current demod_ff stage 1 + body
(each its own compiled program):
  agc_z4   block AGC (RMS) + unnormalized z^4 CFO estimate
  rot      + rotator-recurrence derotation
  rrc      + RRC matched filter (fir_stream_pair)   [= stage 1]
  full     the real _demod_block_impl

Usage: python scripts/ablate_ff.py [variant] [C] [T] [k]
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
    from tetra_tpu import params as P
    from tetra_tpu.core.fir import fir_stream_pair
    from tetra_tpu.rx import demod_ff as FF
    from tetra_tpu.rx import demod_fast as DF
    from tetra_tpu.rx.demod import _tables

    variant = sys.argv[1] if len(sys.argv) > 1 else "full"
    C = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 4608
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 32

    def prefix(state, xr, xi, upto):
        rrc, _, _ = _tables()
        amp_mean = jnp.sqrt(jnp.maximum(
            jnp.mean(xr * xr + xi * xi, axis=1), 1e-18))
        gain = jnp.clip(P.AGC_SETPOINT / amp_mean, 1e-7, P.AGC_MAX_GAIN)
        yr = xr * gain[:, None]
        yi = xi * gain[:, None]
        dzr = yr[:, 2:] * yr[:, :-2] + yi[:, 2:] * yi[:, :-2]
        dzi = yi[:, 2:] * yr[:, :-2] - yr[:, 2:] * yi[:, :-2]
        z2r = dzr * dzr - dzi * dzi
        z2i = 2.0 * dzr * dzi
        z4r = jnp.mean(z2r * z2r - z2i * z2i, axis=1)
        z4i = jnp.mean(2.0 * z2r * z2i, axis=1)
        w = (jnp.arctan2(z4i, z4r) - np.pi) / 8.0
        if upto == "agc_z4":
            st = state._replace(rot_freq=w, agc_gain=gain)
            return st, yr.sum() + yi.sum() + w.sum()
        cr, sr0 = DF.rot_ramp(state.rot_phase, w, xr.shape[1],
                              time_first=False)
        rotr = yr * cr + yi * sr0
        roti = yi * cr - yr * sr0
        if upto == "rot":
            st = state._replace(rot_freq=w, agc_gain=gain)
            return st, rotr.sum() + roti.sum()
        mfr, mfi, rtr, rti = fir_stream_pair(
            rotr, roti, jnp.asarray(rrc), state.rrc_tail_re,
            state.rrc_tail_im)
        st = state._replace(rrc_tail_re=rtr, rrc_tail_im=rti,
                            rot_freq=w, agc_gain=gain)
        return st, mfr.sum() + mfi.sum()

    if variant == "full":
        impl = lambda st, xr, xi: FF._demod_block_impl(st, xr, xi)
    else:
        impl = lambda st, xr, xi: prefix(st, xr, xi, variant)

    def body(state, xs):
        st, out = impl(state, xs[0], xs[1])
        if isinstance(out, dict):
            return st, out["dist"].sum()
        return st, out

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

    state, s0 = run(state, xr, xi)
    float(s0)
    t0 = time.perf_counter()
    for _ in range(3):
        state, sv = run(state, xr, xi)
        float(sv)
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps({"variant": variant, "sec_per_dispatch": round(dt, 4),
                      "msps": round(C * T * k / dt / 1e6, 1)}))


if __name__ == "__main__":
    main()
