"""Multi-host wideband receiver bring-up (jax.distributed launcher).

Run ONE copy of this program per host (BASELINE config 5 shape: each host
ingests its own wideband antenna feed; channels never cross hosts, so
samples/s scales linearly with hosts — parallel/mesh.py design):

    python -m tetra_tpu.apps.multihost --coordinator host0:9999 \
        --num-processes 4 --process-id $RANK capture_$RANK.c64 --channels 16

Every flag defaults to single-process operation so the same entry point
serves bring-up on one box (including CPU virtual meshes for rehearsal:
`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu ...
--hosts 2 --chips 4 --selftest`).

The reference plugin has no distributed operation at all (SURVEY.md
section 2.10: one VFO = one channel, single process); this launcher is the
capability extension that drives the 2-D (host, chip) mesh of
parallel/mesh.py on real clusters:

  * `jax.distributed.initialize` wires the processes (DCN).
  * Each process feeds its OWN host's raw wideband window into the global
    host-sharded arrays (addressable shards only — no cross-host copies).
  * One jitted step channelizes, resamples and demodulates all channels;
    the only DCN traffic is the psum'd fleet health scalar.
  * Each host runs burst sync + the batched MAC stack on its local
    channels and prints per-host lock/decode status plus fleet metrics.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None,
                    help="this host's raw complex64 wideband IQ file "
                         "(omit with --selftest)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="jax.distributed coordinator address "
                         "(omit for single-process)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--channels", type=int, default=16,
                    help="25 kHz channels per host (input rate = "
                         "channels*25 kHz)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="host-axis size (default: num-processes; set "
                         "higher on one process to rehearse a virtual "
                         "multi-host mesh)")
    ap.add_argument("--chips", type=int, default=None,
                    help="chip-axis size (default: local device count)")
    ap.add_argument("--t50", type=int, default=6400,
                    help="50 kHz samples per step per channel")
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = until input ends)")
    ap.add_argument("--status-every", type=int, default=5,
                    help="print status every N steps")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize one TETRA cell per host instead of "
                         "reading input, and validate decode at the end")
    return ap


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.input is None and not args.selftest:
        print("error: need an input file or --selftest", file=sys.stderr)
        return 2

    import jax
    if args.coordinator is not None:
        jax.distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id)
    from .. import params as P
    from ..parallel import channelizer as CH
    from ..parallel.mesh import (make_mesh_2d, sharded_wideband_demod_init,
                                 sharded_wideband_demod_step)
    from ..rx import demod as demod_exact
    from ..rx.burst_sync import BurstSync
    from ..rx.lower_mac import LowerMac, process_bursts_multi
    from ..rx.tdma import PhyState

    n_dev = len(jax.devices())
    n_hosts = args.hosts or args.num_processes
    n_chips = args.chips or (n_dev // n_hosts)
    n_ch = args.channels
    mesh = make_mesh_2d(n_hosts, n_chips)
    step, wide_len, advance = sharded_wideband_demod_step(mesh, n_ch,
                                                          t50_new=args.t50)
    state = sharded_wideband_demod_init(mesh, n_ch)
    fs = n_ch * 25_000
    pid = args.process_id
    print(f"[host {pid}] mesh (host={n_hosts}, chip={n_chips}), "
          f"{n_ch} ch/host @ {fs/1e6:.1f} MS/s, window {wide_len} "
          f"(+{advance}/step)")

    # ---- input: one wideband stream per LOCAL host row ---------------------
    local_rows = [h for h in range(n_hosts)
                  if mesh.devices[h, 0].process_index == jax.process_index()]
    if args.selftest:
        from ..rx.tdma import TdmaTime
        from ..tx import cell
        from ..tx.channel import channel as tx_channel
        from ..tx.modulator import modulate
        from ..tx.wideband import assemble_wideband
        import jax.numpy as jnp

        cell_cfgs, raws = {}, {}
        for h in local_rows:
            cfg = cell.CellConfig(mcc=200 + h, mnc=100 + h, cc=1 + h)
            bits, _ = cell.downlink_bits(cfg, 200,
                                         start=TdmaTime(mn=1, fn=17, tn=4))
            x = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
            wide = assemble_wideband({3: x}, n_ch, amplitude=0.5)
            wide = np.asarray(tx_channel(
                jnp.asarray(wide[None]), jax.random.key(h), snr_db=15.0,
                cfo_hz=150.0, sample_rate=float(fs)))[0]
            cell_cfgs[h], raws[h] = cfg, wide
        feeds = {h: (lambda h=h: raws[h]) for h in local_rows}
        total_raw = min(len(r) for r in raws.values())
    else:
        raw = np.fromfile(args.input, np.complex64)
        feeds = {h: (lambda: raw) for h in local_rows}
        total_raw = len(raw)

    # ---- host-side decode stacks for the local channels ---------------------
    phys = [PhyState() for _ in range(len(local_rows) * n_ch)]
    syncs = [BurstSync(phy=p) for p in phys]
    macs = [LowerMac(phy=p) for p in phys]

    from jax.sharding import NamedSharding, PartitionSpec

    hspec = NamedSharding(mesh, PartitionSpec("host"))

    def host_sharded(make_row):
        """Assemble a (n_hosts, wide_len) array from per-host local rows."""
        return jax.make_array_from_callback(
            (n_hosts, wide_len), hspec,
            lambda idx: make_row(idx[0].start or 0)[None, :])

    n_steps = (total_raw - wide_len) // advance + 1
    if args.steps:
        n_steps = min(n_steps, args.steps)
    t0 = time.time()
    fleet_dist = float("nan")
    for it in range(n_steps):
        s0 = it * advance

        def row(h):
            src = feeds[h]() if h in feeds else np.zeros(total_raw,
                                                         np.complex64)
            return src[s0:s0 + wide_len]

        wr = host_sharded(lambda h: row(h).real.astype(np.float32))
        wi = host_sharded(lambda h: row(h).imag.astype(np.float32))
        state, outs = step(state, wr, wi)
        fleet_dist = float(outs["fleet_dist"])
        # pull only the addressable (this host's) channel shards
        local = {}
        for key in ("dibits", "valid"):
            rows = sorted(outs[key].addressable_shards,
                          key=lambda s: s.index[0].start or 0)
            local[key] = np.concatenate([np.asarray(s.data) for s in rows], 0)
        feed_macs, feed_bursts = [], []
        for c in range(local["dibits"].shape[0]):
            v = local["valid"][c]
            if not v.any():
                continue
            bits = demod_exact.dibits_to_bits(local["dibits"][c][v])
            bursts = syncs[c].feed(bits)
            if bursts:
                feed_macs.append(macs[c])
                feed_bursts.append(bursts)
        if feed_macs:
            process_bursts_multi(feed_macs, feed_bursts)
        if args.status_every and (it + 1) % args.status_every == 0:
            locked = sum(s.state == 2 for s in syncs)
            crc_ok = sum(m.crc_oks for m in macs)
            rate = (it + 1) * advance * len(local_rows) / (time.time() - t0)
            print(f"[host {pid}] step {it+1}/{n_steps} locked {locked}/"
                  f"{len(syncs)} crc_ok {crc_ok} fleet_dist "
                  f"{fleet_dist:.3f} {rate/1e6:.1f} MS/s/host")

    locked = sum(s.state == 2 for s in syncs)
    crc_ok = sum(m.crc_oks for m in macs)
    wall = time.time() - t0
    print(f"[host {pid}] done: {n_steps} steps, locked {locked}, "
          f"crc_ok {crc_ok}, fleet_dist {fleet_dist:.3f}, "
          f"{n_steps*advance*len(local_rows)/wall/1e6:.1f} MS/s/host")

    if args.selftest:
        ok = True
        for i, h in enumerate(local_rows):
            m = macs[i * n_ch + 3]
            d = m.upper.display
            want = cell_cfgs[h]
            good = (d.mcc, d.mnc, d.cc) == (want.mcc, want.mnc, want.cc)
            print(f"[host {pid}] row {h} ch3: mcc/mnc/cc = "
                  f"{d.mcc}/{d.mnc}/{d.cc} "
                  f"({'OK' if good else 'MISMATCH'}), crc_ok {m.crc_oks}")
            ok &= good and m.crc_oks > 40
        print(f"[host {pid}] SELFTEST {'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    from .. import compile_cache
    compile_cache.enable()
    sys.exit(main())
