"""Multi-chip sharding for the demod pipeline (jax.sharding + shard_map).

The scale-out axes (SURVEY.md section 2.10):
  * "ch" (data parallel): independent 25 kHz channels — the demod chain is
    embarrassingly parallel across channels, so the (C, T) batch shards its
    channel axis across the mesh with NO communication.
  * "t" (sequence parallel): within-channel time sharding for the stateless
    convolution stages, using overlap-save with halo exchange via
    `jax.lax.ppermute` (the reference's only "communication backend" is
    in-process stream buffers; this is the multi-device analog).

The per-sample feedback loops carry state along time and therefore stay
sequential per channel; scaling comes from the channel axis, exactly as the
build plan prescribes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

from ..core.fir import fir_valid
from ..rx import demod_fast as demod_mod


def make_mesh(n_devices: int | None = None, axis: str = "ch") -> Mesh:
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devs), (axis,))


# ---------------------------------------------------------------------------
# Channel-sharded demod (dp axis)
# ---------------------------------------------------------------------------


def sharded_demod_step(mesh: Mesh, block_len: int):
    """Build a jitted multi-chip demod step: (state, iq (C,T)) -> (state, outs).

    Channels shard across the mesh; each device runs the full chain on its
    local channels.  State is sharded identically so no resharding happens
    between blocks.
    """
    n_chunks = demod_mod.n_chunks_for(block_len)

    def step(state, xr, xi):
        return demod_mod._demod_block_impl(state, xr, xi, n_chunks)

    cspec = Pspec("ch")
    state_spec = jax.tree.map(lambda _: cspec, demod_mod.demod_init(1))
    out_spec = dict(sym_re=cspec, sym_im=cspec, dibits=cspec, valid=cspec,
                    dist=cspec, fll_freq=cspec, agc_gain=cspec)
    shard = jax.shard_map(step, mesh=mesh,
                          in_specs=(state_spec, cspec, cspec),
                          out_specs=(state_spec, out_spec))
    return jax.jit(shard)


def sharded_demod_init(mesh: Mesh, channels: int) -> demod_mod.DemodState:
    state = demod_mod.demod_init(channels)
    spec = NamedSharding(mesh, Pspec("ch"))
    return jax.tree.map(lambda x: jax.device_put(x, spec), state)


# ---------------------------------------------------------------------------
# Time-sharded overlap-save FIR with ppermute halo exchange (sp axis)
# ---------------------------------------------------------------------------


def halo_fir(mesh: Mesh, h: np.ndarray, axis: str = "t"):
    """Build a time-sharded streaming FIR: each device holds a contiguous
    time shard of every channel; the (M-1)-sample halo travels left->right
    between neighbor shards via `lax.ppermute`.

    Returns a jitted fn: x (C, T_total) sharded on time -> y same sharding,
    where y matches the unsharded causal convolution (zero history at t=0).
    Operates on a float32 plane (run once for re and once for im).
    """
    M = len(h)
    n = mesh.shape[axis]
    hj = jnp.asarray(np.asarray(h, np.float32))

    def local(x):
        # x: (C, T_local) this device's shard
        halo = x[:, -(M - 1):]
        # send my trailing halo to my right neighbor
        left_halo = jax.lax.ppermute(
            halo, axis, [(i, i + 1) for i in range(n - 1)])
        idx = jax.lax.axis_index(axis)
        left_halo = jnp.where(idx == 0, jnp.zeros_like(left_halo), left_halo)
        ext = jnp.concatenate([left_halo, x], axis=1)
        return fir_valid(ext, hj)

    shard = jax.shard_map(local, mesh=mesh,
                          in_specs=Pspec(None, axis),
                          out_specs=Pspec(None, axis))
    return jax.jit(shard)


# ---------------------------------------------------------------------------
# Multi-host: 2-D (host, chip) mesh — per-host wideband ingestion
# ---------------------------------------------------------------------------


def make_mesh_2d(n_hosts: int, n_chips: int) -> Mesh:
    """(host, chip) mesh: the host axis maps to network-connected workers,
    the chip axis to each worker's local devices."""
    devs = np.array(jax.devices()[: n_hosts * n_chips])
    return Mesh(devs.reshape(n_hosts, n_chips), ("host", "chip"))


def sharded_wideband_demod_step(mesh: Mesh, n_ch: int, t50_new: int = 6400):
    """Multi-host front end (BASELINE config 5 shape, scaled by mesh size):
    each host ingests its own n_ch x 25 kHz wideband antenna feed,
    channelizes + resamples it locally, and its n_ch channels shard over
    that host's chips for the chunked demod.

    The host axis carries NO bulk traffic — feeds are per-host, channels
    never cross hosts — so samples/s scales linearly with hosts (the >=80%
    1->N-host efficiency target is met by construction; DCN carries only the
    scalar psum'd health metric below).  Within a host the channelizer runs
    replicated per chip (its FLOPs are ~1% of the demod's); each chip slices
    its own channel range BEFORE resampling, avoiding an all-to-all, and the
    18/25 resampler carries per-channel history in the step state so blocks
    continue the sample stream exactly (no per-block transients).

    t50_new: 50 kHz samples produced per step; must be a multiple of 25 with
    t36 = t50_new*18/25 a multiple of the demod chunk (default 6400 -> 4608).

    Returns (jitted step, wide_len, advance): feed raw windows wr/wi of
    shape (n_hosts, wide_len) float32 host-sharded, advancing the raw
    stream by `advance` samples per step (windows overlap by the filterbank
    history).  outs channel axis is host-major: global channel index =
    h*n_ch + chip*ch_per_chip + j.  outs["fleet_dist"] is the psum'd global
    mean symbol distance — cross-host health in one collective.
    """
    from . import channelizer as CH

    n_chips = mesh.shape["chip"]
    assert n_ch % n_chips == 0, "channels must split evenly over chips"
    ch_per_chip = n_ch // n_chips
    hop = n_ch // 2
    L = n_ch * CH.TAPS_PER_BRANCH
    assert t50_new % 25 == 0
    t36 = t50_new * 18 // 25
    assert t36 % demod_mod.K_SAMP == 0, (
        f"t50_new {t50_new} gives t36={t36}, not a multiple of the demod "
        f"chunk K_SAMP={demod_mod.K_SAMP}")
    wide_len = (t50_new - 1) * hop + L
    advance = t50_new * hop
    n_chunks = demod_mod.n_chunks_for(t36)

    def step(state, wr, wi):
        dstate, hr, hi = state
        yr, yi = CH._channelize_block(wr[0], wi[0], n_ch)  # (n_ch, t50_new)
        c0 = jax.lax.axis_index("chip") * ch_per_chip
        yr = jax.lax.dynamic_slice_in_dim(yr, c0, ch_per_chip, 0)
        yi = jax.lax.dynamic_slice_in_dim(yi, c0, ch_per_chip, 0)
        rr, ri, hr, hi = CH._resample_stream_block(yr, yi, hr, hi, t36)
        dstate, outs = demod_mod._demod_block_impl(dstate, rr, ri, n_chunks)
        nv = jnp.sum(outs["valid"]).astype(jnp.float32)
        ds = jnp.sum(jnp.where(outs["valid"], outs["dist"], 0.0))
        tot = jax.lax.psum(jnp.stack([ds, nv]), ("host", "chip"))
        outs = dict(outs, fleet_dist=tot[0] / jnp.maximum(tot[1], 1.0))
        return (dstate, hr, hi), outs

    cspec = Pspec(("host", "chip"))
    state_spec = (jax.tree.map(lambda _: cspec, demod_mod.demod_init(1)),
                  cspec, cspec)
    out_spec = dict(sym_re=cspec, sym_im=cspec, dibits=cspec, valid=cspec,
                    dist=cspec, fll_freq=cspec, agc_gain=cspec,
                    fleet_dist=Pspec())
    shard = jax.shard_map(step, mesh=mesh,
                          in_specs=(state_spec, Pspec("host"), Pspec("host")),
                          out_specs=(state_spec, out_spec))
    return jax.jit(shard), wide_len, advance


def sharded_wideband_superblock_step(mesh: Mesh, n_ch: int,
                                     t50_new: int = 6400, kw: int = 2):
    """The PRODUCTION back half under sharding: the
    K-cycle superblock program — channelize -> 18/25 resample -> chunked
    demod -> time-major 2-bit+counts packing, the exact semantics of
    rx/receiver._wideband_step_scan — on the 2-D (host, chip) mesh.  Each
    host ingests its own wideband feed; its channels shard over its chips;
    the packed fleet-feed array comes back with GLOBAL channel columns
    (host-major), exactly what FleetEngine.process_packed2 consumes, so a
    multi-host deployment runs fleet burst sync per host on its gathered
    shard.  A psum'd (valid count, dist sum) pair rides the mesh as the
    cross-host fleet-health scalar (the only DCN traffic).

    Returns (jitted step, wide_len, advance).  step(state, wrk, wik) with
    wrk/wik (n_hosts, kw, wide_len) host-sharded float32 ->
    (state, packed (kw*G + 2, n_hosts*n_ch) int32, health (2,)) where
    G = n_chunks*2 + ceil(n_chunks/4) rows per cycle (the pack_cycle_tc
    2-bit symbol words + per-chunk valid-count words).
    Rows [-2]/[-1] of `packed` are the f32-bitcast per-channel vcount/dsum
    (same contract as the single-chip superblock)."""
    from . import channelizer as CH

    n_chips = mesh.shape["chip"]
    assert n_ch % n_chips == 0, "channels must split evenly over chips"
    ch_per_chip = n_ch // n_chips
    hop = n_ch // 2
    L = n_ch * CH.TAPS_PER_BRANCH
    assert t50_new % 25 == 0
    t36 = t50_new * 18 // 25
    assert t36 % demod_mod.K_SAMP == 0
    wide_len = (t50_new - 1) * hop + L
    advance = t50_new * hop
    n_chunks = demod_mod.n_chunks_for(t36)

    def step(state, wrk, wik):
        dstate0, hr0, hi0 = state

        def body(carry, xs):
            dstate, hr, hi, vacc, dacc = carry
            wr, wi = xs                     # (wide_len,) raw window
            yr, yi = CH._channelize_block(wr, wi, n_ch)
            c0 = jax.lax.axis_index("chip") * ch_per_chip
            yr = jax.lax.dynamic_slice_in_dim(yr, c0, ch_per_chip, 0)
            yi = jax.lax.dynamic_slice_in_dim(yi, c0, ch_per_chip, 0)
            rr, ri, hr, hi = CH._resample_stream_block(yr, yi, hr, hi, t36)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr, ri, n_chunks, tc_out=True)
            # packing bit-identical to _wideband_step_scan (shared helper)
            from ..rx.receiver import pack_cycle_tc
            packed, vinc, dinc = pack_cycle_tc(
                outs["dibits_tc"], outs["valid_tc"], outs["dist_tc"],
                ch_per_chip, n_chunks)
            return (dstate, hr, hi, vacc + vinc, dacc + dinc), packed

        zero = jnp.zeros((ch_per_chip,), jnp.float32)
        (dstate, hr, hi, vacc, dacc), packed_k = jax.lax.scan(
            body, (dstate0, hr0, hi0, zero, zero), (wrk[0], wik[0]))
        G = packed_k.shape[1]
        out = jnp.concatenate([
            packed_k.reshape(kw * G, ch_per_chip),
            jax.lax.bitcast_convert_type(vacc, jnp.int32)[None],
            jax.lax.bitcast_convert_type(dacc, jnp.int32)[None]], axis=0)
        health = jax.lax.psum(
            jnp.stack([jnp.sum(vacc), jnp.sum(dacc)]), ("host", "chip"))
        return (dstate, hr, hi), out, health

    cspec = Pspec(("host", "chip"))
    state_spec = (jax.tree.map(lambda _: cspec, demod_mod.demod_init(1)),
                  cspec, cspec)
    shard = jax.shard_map(
        step, mesh=mesh,
        in_specs=(state_spec, Pspec("host"), Pspec("host")),
        out_specs=(state_spec, Pspec(None, ("host", "chip")), Pspec()),
        check_vma=False)  # see sharded_fec_decode
    return jax.jit(shard), wide_len, advance


def sharded_fec_decode(mesh: Mesh, axis: str = "ch"):
    """Row-sharded mixed-FEC decode: each device runs
    the SAME packed-transfer mixed program the single-chip fleet path runs
    (rx/fec._decode_mixed_packed_jit) on its shard of the type-5 rows —
    FEC rows are embarrassingly parallel, so the only collective is a
    psum'd crc-ok count (fleet health).  Returns a jitted fn
    (t5p (N, 54) uint8 row-sharded, ks_table (16, 432) replicated,
    scramb_idx (N,), tsel (N,)) -> (out (N, 35) row-sharded, ok_total)."""
    from ..rx import fec as rx_fec

    def local(t5p, ks_table, idx, tsel):
        out = rx_fec._decode_mixed_packed_jit(t5p, ks_table, idx, tsel)
        ok_total = jax.lax.psum(
            jnp.sum(out[:, -1].astype(jnp.int32)), axis)
        return out, ok_total

    rspec = Pspec(axis)
    shard = jax.shard_map(local, mesh=mesh,
                          in_specs=(rspec, Pspec(), rspec, rspec),
                          out_specs=(rspec, Pspec()),
                          # the per-shard bodies are the single-device
                          # programs, whose lax.scan carries start from
                          # replicated constants (accumulators, Viterbi start
                          # metrics); the varying-axes check would demand
                          # pcasts inside that shared code
                          check_vma=False)
    return jax.jit(shard)


def sharded_wideband_demod_init(mesh: Mesh, n_ch: int):
    """(demod state, resampler history) for n_hosts*n_ch channels,
    host-major, sharded over the 2-D mesh so step() never reshards."""
    from . import channelizer as CH

    C = mesh.shape["host"] * n_ch
    state = demod_mod.demod_init(C)
    spec = NamedSharding(mesh, Pspec(("host", "chip")))
    state = jax.tree.map(lambda x: jax.device_put(x, spec), state)
    hist = jnp.zeros((C, CH.RS_TAPS_PER_PHASE - 1), jnp.float32)
    return (state, jax.device_put(hist, spec), jax.device_put(hist, spec))
