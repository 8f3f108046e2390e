"""Benchmark: IQ Msamples/s through the demod chain, and the whole receiver.

Prints two JSON lines, each naming the device (platform, device_kind, count)
and the card's name and power limit:
  1. demod_chain_throughput_heterogeneous_fleet: the production demod block
     (AGC -> FLL -> RRC -> timing -> Costas -> slicer, superblock form) at one
     fixed shape, (2048 channels, T=4608, k=16 blocks per dispatch), on a
     HETEROGENEOUS locked fleet: every channel carries a real modulated TETRA
     downlink with its own carrier offset (+-1 kHz), sample-clock ppm
     (+-100), timing phase and SNR (15..30 dB).
  2. e2e_wideband_iq_to_pdu_throughput: scripts/bench_e2e.py --resident at
     256 channels, k=32 -- wideband IQ to decoded PDUs through channelize,
     resample, demod, burst sync, FEC and MAC, with decode-level gates --
     median of TETRA_BENCH_E2E_RUNS (default 3) fresh processes, run BEFORE
     this process touches the GPU so that one process holds the card at a
     time.
vs_baseline is the ratio to the reference's implied real-time floor of one
36 kS/s channel per desktop CPU (BASELINE.md).  Any failure fails the run:
there is no fallback shape and no zero line.
"""

import json
import time

import numpy as np


def locked_downlink_iq(n_samples: int) -> np.ndarray:
    """One continuous TETRA downlink stream (complex64, 2 sps) from the
    host-side numpy modulator (generation stays off the device)."""
    from tetra_tpu.core.taps import root_raised_cosine
    from tetra_tpu.tx.cell import CellConfig, downlink_bits
    from tetra_tpu.tx.modulator import _DIBIT_PHASE
    from tetra_tpu import params as P

    n_bits = n_samples  # 2 bits/symbol at 2 samples/symbol
    n_slots = -(-n_bits // P.BITS_PER_TS) + 1
    bits, _ = downlink_bits(CellConfig(), n_slots)
    bits = bits[:n_bits]
    dib = (bits[0::2] << 1) | bits[1::2]
    phase = np.cumsum(np.asarray(_DIBIT_PHASE)[dib])
    syms = np.exp(1j * phase).astype(np.complex64)
    up = np.zeros(2 * len(syms), np.complex64)
    up[::2] = syms
    h = np.asarray(root_raised_cosine(P.RRC_TAP_COUNT, P.RRC_ALPHA, 1.0, 2.0),
                   np.float32) * 2.0
    ext = np.concatenate([np.zeros(len(h) - 1, np.complex64), up])
    return np.convolve(ext, h, mode="valid").astype(np.complex64)


def heterogeneous_fleet_iq(k: int, channels: int, block: int,
                           seed: int = 2):
    """(k, channels, block) float32 re/im arrays: one locked downlink
    stream per channel with independent CFO (+-1 kHz), sample-clock ppm
    (+-100), timing phase, and SNR (15..30 dB).  Pure host numpy."""
    rng = np.random.default_rng(seed)
    n = k * block
    margin = 4096
    base = locked_downlink_iq(n + margin)
    xr = np.empty((channels, n), np.float32)
    xi = np.empty((channels, n), np.float32)
    tgrid = np.arange(n, dtype=np.float64)
    cfo = rng.uniform(-1000.0, 1000.0, channels) * (2 * np.pi / 36000.0)
    ppm = rng.uniform(-100.0, 100.0, channels) * 1e-6
    phase0 = rng.uniform(0.0, 2 * np.pi, channels)
    start = rng.uniform(0.0, 510.0, channels)          # timing phase (samples)
    snr_db = rng.uniform(15.0, 30.0, channels)
    for c in range(channels):
        tt = start[c] + (1.0 + ppm[c]) * tgrid
        y = np.interp(tt, np.arange(len(base)), base.real) \
            + 1j * np.interp(tt, np.arange(len(base)), base.imag)
        y = y * np.exp(1j * (cfo[c] * tgrid + phase0[c]))
        amp = np.sqrt(np.mean(np.abs(y) ** 2))
        sigma = amp * 10 ** (-snr_db[c] / 20.0) / np.sqrt(2.0)
        xr[c] = y.real + sigma * rng.standard_normal(n)
        xi[c] = y.imag + sigma * rng.standard_normal(n)
    return (xr.reshape(channels, k, block).transpose(1, 0, 2).copy(),
            xi.reshape(channels, k, block).transpose(1, 0, 2).copy())


def _run_e2e_fresh_process() -> dict:
    """Whole-receiver e2e measurement: the MEDIAN of >= 1 runs, each in a
    fresh interpreter (so the demod phase's allocations cannot contend with
    it), each run's throughput recorded.  Raises when any run fails."""
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "bench_e2e.py")
    n_runs = max(1, int(os.environ.get("TETRA_BENCH_E2E_RUNS", "3")))
    results = []
    for _ in range(n_runs):
        r = subprocess.run(
            [sys.executable, script, "--resident", "--channels", "256",
             "--t50", "6400", "--k", "32", "--seconds", "16.0"],
            capture_output=True, text=True, timeout=3000)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines or not lines[-1].startswith("{"):
            raise RuntimeError(f"bench_e2e failed (rc={r.returncode}): "
                               f"{r.stderr[-2000:]}")
        results.append(json.loads(lines[-1]))
    results.sort(key=lambda d: d["wideband_msps"])
    med = dict(results[len(results) // 2])
    med["e2e_runs"] = [
        {"wideband_msps": d["wideband_msps"],
         "sb_wall_ms": d.get("sb_wall_ms")} for d in results]
    return med


def main():
    e2e = _run_e2e_fresh_process()

    from tetra_tpu import compile_cache, device_info
    compile_cache.enable()
    devs, card = device_info.require_gpu()
    import jax
    import jax.numpy as jnp

    from tetra_tpu.rx import demod_fast as demod_mod

    channels, block, k = 2048, 4608, 16
    n_chunks = demod_mod.n_chunks_for(block)

    def body(state, xs):
        xr, xi = xs
        # tc_out=True: the superblock demod form the receiver runs
        state, outs = demod_mod._demod_block_impl(
            state, xr, xi, n_chunks, tc_out=True)
        # scalar checksum inside the jit forces execution without a
        # separate reduction program
        return state, outs["dist_tc"].sum()

    @jax.jit
    def step(state, xr_k, xi_k):
        # k blocks per dispatch (lax.scan, the demod_fast.demod_blocks
        # bulk path): the per-dispatch host overhead amortizes over k
        state, sums = jax.lax.scan(body, state, (xr_k, xi_k))
        return state, sums.sum()

    xr_h, xi_h = heterogeneous_fleet_iq(k, channels, block)
    xr = jnp.asarray(xr_h)
    xi = jnp.asarray(xi_h)
    del xr_h, xi_h
    state = demod_mod.demod_init(channels)
    state, chk = step(state, xr, xi)   # compile + warmup
    float(chk)
    state, chk = step(state, xr, xi)
    float(chk)
    iters = 6
    t0 = time.perf_counter()
    # pipelined dispatch: every call chains on the previous carry, so the
    # device work stays ordered; the final scalar fetches force it all
    chks = []
    for _ in range(iters):
        state, chk = step(state, xr, xi)
        chks.append(chk)
    for c in chks:
        float(c)
    dt = time.perf_counter() - t0
    msps = k * channels * block * iters / dt / 1e6
    device = device_info.describe(devs)
    print(json.dumps({
        "metric": "demod_chain_throughput_heterogeneous_fleet",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / 0.036,
        "device": device, "card": card,
        "config": {"channels": channels, "block": block, "k": k},
    }), flush=True)
    cfg_keys = ("channels", "t50", "k", "locked", "crc_ok", "crc_fail",
                "sb_air_ms", "sb_wall_ms", "sb_wall_p95_ms",
                "latency_first_ms", "rt_margin", "host_upload_MBps",
                "e2e_runs")
    print(json.dumps({
        "metric": "e2e_wideband_iq_to_pdu_throughput",
        "value": e2e["wideband_msps"],
        "unit": "wideband Msamples/s",
        "vs_baseline": e2e["rt_channels"],
        "device": e2e["device"], "card": e2e["card"],
        "config": {k2: e2e[k2] for k2 in cfg_keys if k2 in e2e},
    }), flush=True)


if __name__ == "__main__":
    main()
