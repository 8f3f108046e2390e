"""Demod-quality probe: mean |phase error| of the production chunked chain.

Runs a fixed table of impairment conditions on CPU so loop / chunk-size
changes can be compared quantitatively:
  clean         sample-aligned TX
  mu=0.5        half-sample timing offset (4 sps modulate, odd decimation)
  100ppm        sample-clock offset via polyphase resampling
  20dB+cfo      operating point (600 Hz CFO, 20 dB SNR)

Prints one JSON line with the mean symbol |dist| (post-settling) per
condition plus the end-to-end BER at the operating point.
"""

import json
import sys

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from scipy.signal import resample_poly

    from tetra_tpu import params as P
    from tetra_tpu.rx import demod_fast
    from tetra_tpu.tx.channel import channel
    from tetra_tpu.tx.modulator import modulate

    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (1, 120_000)).astype(np.uint8)

    def run(iq, skip=30_000):
        T = iq.shape[1] // demod_fast.K_SAMP * demod_fast.K_SAMP
        iq = iq[:, :T]
        state = demod_fast.demod_init(1)
        state, outs = demod_fast.demod_block(state, iq)
        dist = np.asarray(outs["dist"])[0]
        valid = np.asarray(outs["valid"])[0]
        d = dist[valid]
        return float(d[skip:].mean())

    iq = np.asarray(modulate(jnp.asarray(bits)))
    res = {"K_SAMP": demod_fast.K_SAMP, "K_SYM": demod_fast.K_SYM}
    res["clean"] = round(run(iq), 4)

    iq4 = np.asarray(modulate(jnp.asarray(bits), sps=4))
    res["mu_half"] = round(run(iq4[:, 1::2]), 4)

    off = resample_poly(iq[0], 10_000, 10_001)[None, :]
    res["ppm100"] = round(run(off.astype(np.complex64)), 4)

    op = np.asarray(channel(jnp.asarray(iq), jax.random.key(2), snr_db=20.0,
                            cfo_hz=600.0, sample_rate=P.SAMPLE_RATE))
    res["op_20db_600hz"] = round(run(op, skip=40_000), 4)

    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
