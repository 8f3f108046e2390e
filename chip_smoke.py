"""Smoke test of the wideband receiver on one GPU: the main path end to end
at 256 carriers, then each device stage against its plain reference.

    python chip_smoke.py              # one GPU, all phases
    python chip_smoke.py --four       # four GPUs: the sharded superblock and
                                      # the row-sharded FEC against one card
    python chip_smoke.py --rehearse   # CPU rehearsal at tiny widths (tests)

Phases, all in this one process (a second JAX process could not get the
card's memory):
  1. device check: the platform must be `gpu` (unless --rehearse); prints
     the card's name and power limit from nvidia-smi.
  2. main path: TetraReceiver(wideband=256, t50=6400, fleet=True, wb_k=8)
     fed ~4 s of a seeded 8-cell multiplex through process_wideband (the
     `tetra_rx --wideband 256 --fleet` path); gates on locks, CRC and every
     carrier's MCC/MNC/CC.
  3. stages against references, at real widths: the front end against a
     float64 NumPy filterbank + 18/25 resampler, the demod chain against the
     same jitted program on the CPU (and, on 8 channels, the per-sample
     rx/demod.py chain at decode level), the typed FEC programs against the
     CPU bit for bit.
Every failure raises; the last line of stdout is one JSON object naming the
device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# the CPU backend is the reference device of phase 3: keep it available
# beside the GPU when the environment names platforms explicitly
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import numpy as np  # noqa: E402

import bench  # noqa: E402
import bench_e2e  # noqa: E402
from tetra_tpu import compile_cache, device_info  # noqa: E402
from tetra_tpu import params as P  # noqa: E402
from tetra_tpu.parallel import channelizer as CH, channelizer_ref  # noqa: E402
from tetra_tpu.rx import demod_fast, fec as rx_fec  # noqa: E402
from tetra_tpu.rx import fleet as fleet_mod  # noqa: E402
from tetra_tpu.rx.receiver import TetraReceiver, _wideband_step_scan  # noqa: E402

# full-size configuration and its CPU rehearsal
FULL = dict(channels=256, t50=6400, wb_k=8, seconds=4.2, demod_blocks=16,
            fec_rows=8192)
TINY = dict(channels=16, t50=1600, wb_k=2, seconds=3.0, demod_blocks=16,
            fec_rows=256)
BLOCK = 4608          # demod block length (36 kHz samples) of phase 3
WARM_AIR_S = 1.5      # acquisition transient excluded from the CRC gate


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def device_check(rehearse: bool, n_want: int):
    devs, card = device_info.require_gpu(rehearse)
    check(len(devs) >= n_want,
          f"need {n_want} devices, jax reports {len(devs)}")
    print(f"nvidia-smi: {device_info.nvidia_smi() or 'not available'}",
          flush=True)
    return devs, card


# ---------------------------------------------------------------------------
# phase 2: the main path end to end
# ---------------------------------------------------------------------------


def main_path(card: str, cfg: dict) -> None:
    import jax
    import jax.numpy as jnp

    C, t50, K = cfg["channels"], cfg["t50"], cfg["wb_k"]
    check(fleet_mod.load() is not None, "native fleet engine did not load")
    t0 = time.perf_counter()
    wide = bench_e2e.build_wideband(C, cfg["seconds"])
    say(card, f"e2e data: {len(wide)} wideband samples "
              f"({len(wide) / (C * 25e3):.2f} s air) built in "
              f"{time.perf_counter() - t0:.1f} s")
    rx = TetraReceiver(wideband=C, t50=t50, fleet=True, events=False,
                       wb_k=K)
    wb = rx._wb
    # ahead-of-time compile of the superblock step: its time and memory
    # (on the card the persistent compile cache then serves the receiver's
    # own call)
    args = (rx.state,
            jax.ShapeDtypeStruct((K, wb["wide_len"]), jnp.float32),
            jax.ShapeDtypeStruct((K, wb["wide_len"]), jnp.float32),
            wb["hist_r"], wb["hist_i"])
    t0 = time.perf_counter()
    compiled = _wideband_step_scan.lower(
        *args, n_ch=C, t36=wb["t36"], n_chunks=wb["n_chunks"], i16=False,
        kw=K).compile()
    compile_s = time.perf_counter() - t0
    say(card, f"e2e superblock compile_s={compile_s:.2f}")
    say(card, f"e2e superblock memory_analysis: "
              f"{compiled.memory_analysis()}")

    sb = K * wb["advance"]
    # after the window-overlap prefix, every sb samples fed make exactly one
    # superblock dispatch
    used = wb["wide_len"] - wb["advance"]
    rx.process_wideband(wide[:used])
    warm_sb = int(np.ceil(WARM_AIR_S * C * 25e3 / sb))
    walls = []
    t_all = time.perf_counter()
    while used + sb <= len(wide):
        ts = time.perf_counter()
        rx.process_wideband(wide[used:used + sb])
        walls.append(time.perf_counter() - ts)
        used += sb
        if len(walls) == warm_sb:
            ok0 = sum(rx.crc_counts(c)[0] for c in range(C))
            fail0 = sum(rx.crc_counts(c)[1] for c in range(C))
    wall = time.perf_counter() - t_all
    n_sb = len(walls)
    check(n_sb >= warm_sb + 2, f"only {n_sb} superblocks of air")
    # the first superblock loads the compiled program; the steady window
    # starts after the acquisition transient (FLL pull-in, scrambling)
    steady = walls[warm_sb:]
    msps = len(steady) * sb / sum(steady) / 1e6
    locked = sum(rx.locked(c) for c in range(C))
    ok_all = sum(rx.crc_counts(c)[0] for c in range(C))
    fail_all = sum(rx.crc_counts(c)[1] for c in range(C))
    ok, fail = ok_all - ok0, fail_all - fail0
    cells = bench_e2e.multiplex_cells(C)
    wrong = [c for c in range(C)
             if (rx.display(c).mcc, rx.display(c).mnc, rx.display(c).cc)
             != (cells[c].mcc, cells[c].mnc, cells[c].cc)]
    say(card, f"e2e wall_s={wall:.3f} superblocks={n_sb} "
              f"superblock_air_s={sb / (C * 25e3):.3f} "
              f"superblock_wall_s={[round(w, 4) for w in walls]} "
              f"steady_wideband_msps={msps:.3f} "
              f"steady_rt_margin={sb / (C * 25e3) / np.mean(steady):.3f}")
    say(card, f"e2e locked={locked}/{C} steady crc_ok={ok} crc_fail={fail} "
              f"(from cold start {ok_all}/{fail_all}) wrong_cell={len(wrong)}")
    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use") if stats else None
    say(card, f"e2e peak_bytes_in_use={peak if peak is not None else 'n/a'}")
    check(locked > 0.9 * C, f"only {locked}/{C} carriers locked")
    check(ok > 3 * fail, f"CRC ok {ok} <= 3 x fail {fail}")
    check(not wrong, f"carriers decoded the wrong cell: {wrong[:16]}")


# ---------------------------------------------------------------------------
# phase 3: stages against references
# ---------------------------------------------------------------------------


def stage_front_end(card: str, cfg: dict) -> None:
    import jax.numpy as jnp
    n_ch, t50 = cfg["channels"], cfg["t50"]
    t36 = t50 * 18 // 25
    hop = n_ch // 2
    wide_len = (t50 - 1) * hop + n_ch * CH.TAPS_PER_BRANCH
    advance = t50 * hop
    rng = np.random.default_rng(5)
    n_blk = 2
    x = (rng.standard_normal(advance * (n_blk - 1) + wide_len)
         + 1j * rng.standard_normal(advance * (n_blk - 1) + wide_len))
    x = x.astype(np.complex64)
    pad = CH.RS_TAPS_PER_PHASE - 1
    hr = hi = jnp.zeros((pad, n_ch), jnp.float32)
    got = []
    for b in range(n_blk):
        w = x[b * advance: b * advance + wide_len]
        rr, ri, hr, hi = CH._front_end_block(
            jnp.asarray(w.real.copy()), jnp.asarray(w.imag.copy()), hr, hi,
            n_ch, t36)
        got.append(np.asarray(rr) + 1j * np.asarray(ri))
    got = np.concatenate(got)
    want = channelizer_ref.front_end(x.astype(np.complex128), n_ch,
                                     n_blk * t50, n_blk * t36)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    say(card, f"stage front_end ({n_ch} ch, {n_blk} blocks of t50={t50}) "
              f"rel_err_vs_float64={rel:.3e} (limit 1e-5)")
    check(rel <= 1e-5, f"front end rel err {rel:.3e} > 1e-5")


def stage_demod(card: str, cfg: dict, cpu) -> None:
    import jax
    C, k = cfg["channels"], cfg["demod_blocks"]
    xr, xi = bench.heterogeneous_fleet_iq(k, C, BLOCK)
    n_chunks = demod_fast.n_chunks_for(BLOCK)

    def run(device, xr, xi, state=None):
        put = lambda a: jax.device_put(a, device)
        state = jax.tree.map(put, state or demod_fast.demod_init(C))
        return demod_fast._demod_scan_impl(state, put(xr), put(xi),
                                           n_chunks)

    def fetch(outs):
        return {f: np.asarray(outs[f]) for f in ("dibits", "valid", "dist")}

    # free-running: the whole fleet stream on each device.  The feedback
    # loops amplify last-bit differences, so the two runs drift apart on
    # noisy symbols (a 1e-6 input perturbation on ONE device does the same);
    # reported, not gated
    dev0 = jax.devices()[0]
    t0 = time.perf_counter()
    dev = fetch(run(dev0, xr, xi)[1])
    dev_s = time.perf_counter() - t0
    n_warm = k - 4
    st_ref, _ = run(cpu, xr[:n_warm], xi[:n_warm])
    free = fetch(run(cpu, xr[n_warm:], xi[n_warm:], st_ref)[1])
    free_same = (free["dibits"] == dev["dibits"][n_warm:]) \
        & free["valid"] & dev["valid"][n_warm:]
    free_agree = free_same.sum() / (free["valid"]
                                    & dev["valid"][n_warm:]).sum()
    # gated: each of the last 4 blocks from the SAME reference state on both
    # devices -- the compiled program's arithmetic, block by block, on the
    # valid symbols of locked (settled) channels
    match = total = 0
    n_locked = []
    st = st_ref
    for b in range(n_warm, k):
        x_r, x_i = xr[b:b + 1], xi[b:b + 1]
        st_next, o_ref = run(cpu, x_r, x_i, st)
        _, o_dev = run(dev0, x_r, x_i, st)
        r, d = fetch(o_ref), fetch(o_dev)
        v = r["valid"][0]
        q = np.where(v, r["dist"][0], 0.0).sum(1) / np.maximum(v.sum(1), 1)
        locked = (q < P.SYNC_QUALITY_THRESHOLD) & (v.sum(1) > 0)
        n_locked.append(int(locked.sum()))
        same = (r["dibits"][0] == d["dibits"][0]) & (v == d["valid"][0])
        match += int((same & v)[locked].sum())
        total += int(v[locked].sum())
        st = st_next
    agree = match / max(total, 1)
    say(card, f"stage demod ({C} ch x {k} blocks of {BLOCK}) "
              f"device_s={dev_s:.2f} locked_per_block={n_locked}/{C} "
              f"dibit_agreement_from_shared_state={agree:.6f} (limit 0.999) "
              f"free_running_agreement={free_agree:.6f}")
    check(min(n_locked) >= 0.8 * C, f"only {min(n_locked)} settled")
    check(agree >= 0.999, f"device vs CPU dibit agreement {agree:.6f}")

    # decode level on 8 channels: the production chain on the device vs the
    # per-sample reference chain (rx/demod.py) on the CPU
    iq = (xr[:, :8] + 1j * xi[:, :8]).astype(np.complex64)
    fast = TetraReceiver(8, mode="fast", events=False)
    with jax.default_device(cpu):
        exact = TetraReceiver(8, mode="exact", events=False)
        for b in range(k):
            exact.process(iq[b])
    for b in range(k):
        fast.process(iq[b])
    rows = []
    for c in range(8):
        f_ok, f_fail = fast.crc_counts(c)
        e_ok, e_fail = exact.crc_counts(c)
        fd, ed = fast.display(c), exact.display(c)
        rows.append((fast.locked(c), exact.locked(c), f_ok, e_ok))
        check(fast.locked(c) and exact.locked(c), f"ch {c} not locked")
        check((fd.mcc, fd.mnc, fd.cc) == (ed.mcc, ed.mnc, ed.cc),
              f"ch {c} display differs")
        check(abs(f_ok - e_ok) <= max(4, 0.03 * e_ok),
              f"ch {c} CRC ok {f_ok} vs per-sample chain {e_ok}")
        check(f_ok > 3 * f_fail and e_ok > 3 * e_fail, f"ch {c} CRC fails")
    say(card, f"stage demod decode-level vs per-sample chain (8 ch): "
              f"(locked_dev, locked_ref, crc_ok_dev, crc_ok_ref)={rows}")


def fec_rows(n: int, seed: int = 3):
    """Seeded FEC rows of every typed-program kind, half of them valid
    encodings (ok flags set), the rest random bits."""
    from tetra_tpu.tx import fec_enc
    rng = np.random.default_rng(seed)
    scr = P.scramb_get_init(262, 4321, 3)
    kinds = ((P.TPSAP_T_SB1, 120, 60), (P.TPSAP_T_SB2, 216, 124),
             (P.TPSAP_T_NDB, 216, 124), (P.TPSAP_T_SCH_F, 432, 268),
             (P.TPSAP_T_BBK, 30, 14))
    t5p = np.zeros((n, 54), np.uint8)
    types = np.empty(n, np.int64)
    idx = np.empty(n, np.int32)
    for r in range(n):
        bt, t345, t1 = kinds[r % len(kinds)]
        sc = P.SCRAMB_INIT if bt == P.TPSAP_T_SB1 else scr
        if r % 2:
            bits = rng.integers(0, 2, t345).astype(np.uint8)
        else:
            bits = fec_enc.encode_block(
                rng.integers(0, 2, t1).astype(np.uint8), bt, sc)
        row = np.zeros(432, np.uint8)
        row[:t345] = bits
        t5p[r] = np.packbits(row)
        types[r] = bt
        idx[r] = 0 if bt == P.TPSAP_T_SB1 else 1
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = rx_fec.keystream(P.SCRAMB_INIT, 432)
    ks[1] = rx_fec.keystream(scr, 432)
    return t5p, types, idx, ks


def stage_fec(card: str, cfg: dict, cpu) -> None:
    import jax
    import jax.numpy as jnp
    t5p, types, idx, ks = fec_rows(cfg["fec_rows"])

    def run(device):
        with jax.default_device(device):
            return rx_fec.decode_rows_typed_packed(
                t5p, types, idx, jnp.asarray(ks))

    t1_dev, ok_dev = run(jax.devices()[0])
    t1_ref, ok_ref = run(cpu)
    say(card, f"stage fec typed ({len(types)} rows) ok_rows="
              f"{int(ok_dev.sum())} bit_equal="
              f"{bool((t1_dev == t1_ref).all() and (ok_dev == ok_ref).all())}")
    check(ok_dev.sum() >= len(types) // 2, "valid encodings did not decode")
    check((t1_dev == t1_ref).all() and (ok_dev == ok_ref).all(),
          "device FEC differs from the CPU")


# ---------------------------------------------------------------------------
# --four: the sharded paths against one card
# ---------------------------------------------------------------------------


def four_cards(card: str, cfg: dict) -> None:
    import jax
    import jax.numpy as jnp
    from tetra_tpu.parallel import mesh as pmesh
    from tetra_tpu.rx.fleet import FleetEngine

    C, t50, K = cfg["channels"], cfg["t50"], cfg["wb_k"]
    t36 = t50 * 18 // 25
    mesh = pmesh.make_mesh_2d(1, 4)
    step, wide_len, advance = pmesh.sharded_wideband_superblock_step(
        mesh, C, t50_new=t50, kw=K)
    state4 = pmesh.sharded_wideband_demod_init(mesh, C)
    n_chunks = demod_fast.n_chunks_for(t36)
    pad = CH.RS_TAPS_PER_PHASE - 1
    state1 = (demod_fast.demod_init(C), jnp.zeros((pad, C), jnp.float32),
              jnp.zeros((pad, C), jnp.float32))
    eng4, eng1 = FleetEngine(C), FleetEngine(C)
    wide = bench_e2e.build_wideband(C, cfg["seconds"])
    sb = K * advance
    n_sb = (len(wide) - (wide_len - advance)) // sb
    check(n_sb >= 3, f"only {n_sb} superblocks of air")
    times4, times1 = [], []
    for s in range(n_sb):
        wins = np.stack([wide[s * sb + j * advance:
                              s * sb + j * advance + wide_len]
                         for j in range(K)])
        wr = wins.real.astype(np.float32)
        wi = wins.imag.astype(np.float32)
        t0 = time.perf_counter()
        state4, out4, health = step(state4, jnp.asarray(wr[None]),
                                    jnp.asarray(wi[None]))
        out4 = np.asarray(out4)
        times4.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        d, out1, hr, hi = _wideband_step_scan(
            state1[0], jnp.asarray(wr), jnp.asarray(wi), state1[1],
            state1[2], C, t36, n_chunks, False, K)
        out1 = np.asarray(out1)
        times1.append(time.perf_counter() - t0)
        state1 = (d, hr, hi)
        eng4.process_packed2(out4[:-2], K, n_chunks)
        eng1.process_packed2(out1[:-2], K, n_chunks)
        check(np.isfinite(np.asarray(health)).all(), "health not finite")
    diff = [c for c in range(C)
            if eng4.crc_counts(c) != eng1.crc_counts(c)
            or eng4.display(c).as_dict() != eng1.display(c).as_dict()]
    locked = sum(eng4.locked(c) for c in range(C))
    ok4 = sum(eng4.crc_counts(c)[0] for c in range(C))
    say(card, f"four superblock ({C} ch over 4 cards, kw={K}) "
              f"superblocks={n_sb} s_per_sb_4cards={[round(t, 4) for t in times4]} "
              f"s_per_sb_1card={[round(t, 4) for t in times1]} "
              f"locked={locked}/{C} crc_ok={ok4} carriers_differing={len(diff)}")
    check(locked > 0.9 * C, f"sharded: only {locked}/{C} locked")
    check(not diff, f"sharded vs one card: carriers differ {diff[:16]}")

    # row-sharded FEC vs the one-card program
    t5p, types, idx, ks = fec_rows(cfg["fec_rows"])
    tsel = rx_fec._MIX_TSEL_OF[types].astype(np.int32)
    fmesh = pmesh.make_mesh(4, "ch")
    dec = pmesh.sharded_fec_decode(fmesh)
    rsh = jax.sharding.NamedSharding(fmesh, jax.sharding.PartitionSpec("ch"))
    got, ok_total = dec(jax.device_put(jnp.asarray(t5p), rsh),
                        jnp.asarray(ks),
                        jax.device_put(jnp.asarray(idx), rsh),
                        jax.device_put(jnp.asarray(tsel), rsh))
    want = np.asarray(rx_fec._decode_mixed_packed_jit(
        jnp.asarray(t5p), jnp.asarray(ks), jnp.asarray(idx),
        jnp.asarray(tsel)))
    equal = bool((np.asarray(got) == want).all())
    say(card, f"four fec ({len(types)} rows over 4 cards) bit_equal={equal} "
              f"ok_total={int(ok_total)}")
    check(equal, "row-sharded FEC differs from one card")
    check(int(ok_total) == int(want[:, -1].astype(np.int64).sum()),
          "psum'd ok count wrong")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths and their "
                         "one-card comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny widths")
    args = ap.parse_args(argv)
    cfg = TINY if args.rehearse else FULL
    if not args.rehearse:
        compile_cache.enable()
    import jax
    devs, card = device_check(args.rehearse, 4 if args.four else 1)
    t_start = time.perf_counter()
    if args.four:
        four_cards(card, cfg)
    else:
        cpu = jax.devices("cpu")[0]
        for name, run in (("main_path", lambda: main_path(card, cfg)),
                          ("front_end", lambda: stage_front_end(card, cfg)),
                          ("demod", lambda: stage_demod(card, cfg, cpu)),
                          ("fec", lambda: stage_fec(card, cfg, cpu))):
            t0 = time.perf_counter()
            run()
            say(card, f"phase {name} passed in "
                      f"{time.perf_counter() - t0:.1f} s")
    say(card, f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device_info.describe(devs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
