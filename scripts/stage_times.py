"""Per-stage device times of the wideband path as XLA builds it, and a
profiler trace of one superblock with its device-kernel count.

    python scripts/stage_times.py [--channels 256] [--t50 6400] [--k 8]
                                  [--out chiprun_out/stage_times.json]

Times (host clock around block_until_ready, warm, median of --iters calls):
  front_end   channelize + 18/25 resample of one cycle (_front_end_block)
  stage1      AGC/FLL + RRC of one demod block (T = t50*18/25)
  stage2      timing/Costas/slicer of one demod block
  demod       the whole demod block (_demod_block_impl)
  superblock  one K-cycle superblock step (_wideband_step_scan), per cycle
Then one superblock and one demod block are traced with jax.profiler; the
trace is reduced to device kernel events (count, busy time) per call.  Each
printed line names the device and the card's power limit; the JSON summary
goes to --out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, iters: int) -> dict:
    """Compile+first call, then the median of `iters` warm calls (s)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return dict(first_s=first, median_s=float(np.median(ts)),
                min_s=float(np.min(ts)), max_s=float(np.max(ts)))


def device_events(trace_dir: str) -> dict:
    """Reduce a jax.profiler trace to the device planes' events: per line
    the event count, and over the stream lines (names containing 'Stream')
    the event count split into kernels and memory copies (event names
    containing 'memcpy'/'memset'), their summed duration and the busy time
    (union of intervals) within the span from first start to last end."""
    import jax
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    lines, ivals = {}, []
    copies = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if "Stream" in line.name:
                ivals += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in evs]
                copies += sum(("memcpy" in e.name.lower()
                               or "memset" in e.name.lower()) for e in evs)
    ivals.sort()
    busy, end = 0.0, -1.0
    for s, e in ivals:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (ivals[-1][1] - ivals[0][0]) if ivals else 0.0
    return dict(events=len(ivals), kernels=len(ivals) - copies,
                copies=copies,
                event_sum_ms=sum(e - s for s, e in ivals) / 1e6,
                busy_ms=busy / 1e6, span_ms=span / 1e6, lines=lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--t50", type=int, default=6400)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/stage_times.json")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal (no device numbers)")
    args = ap.parse_args()

    from tetra_tpu import compile_cache, device_info
    compile_cache.enable()
    devs, card = device_info.require_gpu(args.rehearse)
    import jax
    import jax.numpy as jnp
    from tetra_tpu.core.fir import fir_stream_pair
    from tetra_tpu.parallel import channelizer as CH
    from tetra_tpu.rx import demod_fast as DF
    from tetra_tpu.rx.demod import _tables
    from tetra_tpu.rx.receiver import _wideband_step_scan

    dev = device_info.describe(devs)
    C, t50, K = args.channels, args.t50, args.k
    t36 = t50 * 18 // 25
    hop = C // 2
    wide_len = (t50 - 1) * hop + C * CH.TAPS_PER_BRANCH
    n_chunks = DF.n_chunks_for(t36)
    pad = CH.RS_TAPS_PER_PHASE - 1
    rng = np.random.default_rng(0)
    wr = jnp.asarray(rng.standard_normal((K, wide_len)).astype(np.float32))
    wi = jnp.asarray(rng.standard_normal((K, wide_len)).astype(np.float32))
    hist = jnp.zeros((pad, C), jnp.float32)
    state = DF.demod_init(C)
    xr = jnp.asarray(rng.standard_normal((C, t36)).astype(np.float32))
    xi = jnp.asarray(rng.standard_normal((C, t36)).astype(np.float32))
    rrc, be, _ = _tables()

    @jax.jit
    def stage1(st, xr, xi):
        rotr, roti, g, p, f, hr, hi = DF._agc_fll_chunked(
            xr, xi, st.agc_gain, st.fll_phase, st.fll_freq, st.fll_hist_re,
            st.fll_hist_im, be)
        mfr, mfi, _, _ = fir_stream_pair(rotr, roti, jnp.asarray(rrc),
                                         st.rrc_tail_re, st.rrc_tail_im)
        return mfr, mfi

    mfr, mfi = stage1(state, xr, xi)

    @jax.jit
    def stage2(st, mfr, mfi):
        outs = DF._mm_costas_chunked(
            mfr, mfi, st.mm_tail_re, st.mm_tail_im, st.mm_pos, st.mm_omega,
            st.cos_phase, st.cos_freq, st.cos_ph2, st.prev_sym, n_chunks)[0]
        return outs["dibits"], outs["valid"], outs["dist"]

    calls = {
        "front_end": lambda: CH._front_end_block(wr[0], wi[0], hist, hist,
                                                 C, t36),
        "stage1": lambda: stage1(state, xr, xi),
        "stage2": lambda: stage2(state, mfr, mfi),
        "demod": lambda: DF._demod_block_impl(state, xr, xi, n_chunks,
                                              tc_out=True),
        "superblock": lambda: _wideband_step_scan(
            state, wr, wi, hist, hist, C, t36, n_chunks, False, K),
    }
    res = dict(device=dev, card=card, channels=C, t50=t50, t36=t36, k=K,
               n_chunks=n_chunks, xla_flags=os.environ.get("XLA_FLAGS", ""),
               times={})
    for name, fn in calls.items():
        r = timed(fn, args.iters)
        if name == "superblock":
            r["median_per_cycle_ms"] = r["median_s"] / K * 1e3
        res["times"][name] = r
        print(f"[{card}] [{dev}] {name} ({C} ch, T={t36}) "
              + " ".join(f"{k}={v:.6g}" for k, v in r.items()), flush=True)

    out_dir = os.path.dirname(os.path.abspath(args.out))
    res["traces"] = {}
    for name in ("superblock", "demod"):
        tdir = os.path.join(out_dir, f"trace_{name}")
        with jax.profiler.trace(tdir):
            jax.block_until_ready(calls[name]())
        ev = device_events(tdir)
        if name == "superblock":
            ev["kernels_per_cycle"] = ev["kernels"] / K
        res["traces"][name] = ev
        print(f"[{card}] [{dev}] trace {name}: events={ev['events']} "
              f"kernels={ev['kernels']} copies={ev['copies']} "
              f"event_sum_ms={ev['event_sum_ms']:.3f} "
              f"busy_ms={ev['busy_ms']:.3f} span_ms={ev['span_ms']:.3f}"
              + (f" kernels_per_cycle={ev['kernels_per_cycle']:.1f}"
                 if "kernels_per_cycle" in ev else ""), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("device", "card", "times")}))


if __name__ == "__main__":
    main()
