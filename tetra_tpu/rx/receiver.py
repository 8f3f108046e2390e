"""Top-level multi-channel TETRA receiver pipeline.

Equivalent of the reference plugin's whole wiring (main.cpp:58-120 +
osmotetra_dec.h) as a streaming object: IQ blocks (channels x time) go
through the batched device demod chain, then per-channel burst sync and the
batched MAC/FEC stack.  One `TetraReceiver` replaces the reference's
11 threaded blocks per single channel - and handles N channels at once.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import demod as demod_exact
from . import demod_fast
from . import demod_ff
from functools import partial

import jax

from .burst_sync import BurstSync
from .lower_mac import LowerMac, process_bursts_multi
from .tdma import PhyState


@partial(jax.jit, static_argnames=("n_ch", "t36", "n_chunks", "i16"))
def _wideband_step(dstate, wr, wi, hr, hi, n_ch: int, t36: int,
                   n_chunks: int, i16: bool = False):
    """Fused wideband block: channelize (frame-major) -> streaming 18/25
    resample -> chunked demod, one device program (the bench_wideband
    cascade as the production receiver path).  Non-fleet consumers only:
    the fleet path always uses _wideband_step_scan (time-major
    nibble-packed output; K=1 is a length-1 scan).

    i16: wr/wi arrive as raw int16 (SDR-native cs16); converting on device
    halves the host->device bytes."""
    from ..parallel import channelizer as CH
    from . import demod_fast

    if i16:
        wr = wr.astype(jnp.float32) * (1.0 / 32768.0)
        wi = wi.astype(jnp.float32) * (1.0 / 32768.0)
    rr, ri, hr, hi = CH._front_end_block(wr, wi, hr, hi, n_ch, t36)
    dstate, outs = demod_fast._demod_block_impl(dstate, rr.T, ri.T,
                                                n_chunks)
    return dstate, outs, hr, hi


def pack_cycle_tc(dib_tc, v32, dist_tc, n_ch: int, n_chunks: int):
    """Pack ONE demod cycle's time-major outputs into the superblock
    fleet-feed rows: (sym_words + cnt_words, C) int32.

      * symbol rows: 16 consecutive symbol slots per int32, 2-bit dibit
        fields (lowest bits first) -- no per-symbol valid bit;
      * count rows: per demod chunk (K_SYM symbols) the VALID-symbol count,
        4 chunk counts per int32 (8-bit fields).  Validity within a chunk
        is always a PREFIX (valid = ipos < T with ipos nondecreasing), so
        a count reconstructs the exact valid set -- asserted against the
        per-symbol flags by tests/test_fleet.py.

    2 bits/symbol + ~0.27 bits/symbol of counts vs the 4-bit nibble form:
    the superblock output fetch shrinks another ~44%."""
    from . import demod_fast
    Ks = demod_fast.K_SYM
    Tp = n_chunks * Ks
    dib = dib_tc & 3
    w = dib.reshape(Tp // 16, 16, n_ch)
    sh2 = (jnp.arange(16, dtype=jnp.int32) * 2)[None, :, None]
    sym_rows = jnp.sum(w << sh2, axis=1, dtype=jnp.int32)
    counts = jnp.sum(v32.reshape(n_chunks, Ks, n_ch), axis=1,
                     dtype=jnp.int32)                      # (n_chunks, C)
    cnt_words = -(-n_chunks // 4)
    pad = cnt_words * 4 - n_chunks
    if pad:
        counts = jnp.concatenate(
            [counts, jnp.zeros((pad, n_ch), jnp.int32)], axis=0)
    wc = counts.reshape(cnt_words, 4, n_ch)
    sh8 = (jnp.arange(4, dtype=jnp.int32) * 8)[None, :, None]
    cnt_rows = jnp.sum(wc << sh8, axis=1, dtype=jnp.int32)
    packed = jnp.concatenate([sym_rows, cnt_rows], axis=0)
    vacc_inc = jnp.sum(v32, axis=0).astype(jnp.float32)
    dacc_inc = jnp.sum(jnp.where(v32.astype(bool), dist_tc, 0.0), axis=0)
    return packed, vacc_inc, dacc_inc


@partial(jax.jit, static_argnames=("n_ch", "t36", "n_chunks", "i16", "kw"))
def _wideband_step_scan(dstate, wrk, wik, hr, hi, n_ch: int, t36: int,
                        n_chunks: int, i16: bool, kw: int):
    """K-cycle superblock: kw overlapping windows (kw, wide_len) run the
    fused front-end + demod under lax.scan and return ONE int32 output
    array of shape (kw*G + 2, C), TIME-MAJOR in the pack_cycle_tc layout
    (G = sym_words + cnt_words rows per cycle; 2-bit symbols + per-chunk
    valid counts); rows [-2]/[-1] carry the f32-bitcast per-channel
    vcount/dsum quality sums.

    Motivation: every device->host fetch pays a fixed round trip; one
    dispatch + one fetch per kw cycles amortizes it, and ~2.3 bits per
    symbol slot cross the link instead of 8.  FleetEngine.process_packed2
    consumes this form directly (fleet_feed_sb reads the streams in
    C++)."""
    from ..parallel import channelizer as CH
    from . import demod_fast

    def body(carry, xs):
        dstate, hr, hi, vacc, dacc = carry
        wr, wi = xs
        if i16:
            wr = wr.astype(jnp.float32) * (1.0 / 32768.0)
            wi = wi.astype(jnp.float32) * (1.0 / 32768.0)
        rr, ri, hr, hi = CH._front_end_block(wr, wi, hr, hi, n_ch, t36)
        dstate, outs = demod_fast._demod_block_impl(
            dstate, rr.T, ri.T, n_chunks, tc_out=True)
        packed, vinc, dinc = pack_cycle_tc(
            outs["dibits_tc"], outs["valid_tc"], outs["dist_tc"], n_ch,
            n_chunks)
        return (dstate, hr, hi, vacc + vinc, dacc + dinc), packed

    zero = jnp.zeros((n_ch,), jnp.float32)
    (dstate, hr, hi, vacc, dacc), packed_k = jax.lax.scan(
        body, (dstate, hr, hi, zero, zero), (wrk, wik))
    G = packed_k.shape[1]
    out = jnp.concatenate([
        packed_k.reshape(kw * G, n_ch),
        jax.lax.bitcast_convert_type(vacc, jnp.int32)[None],
        jax.lax.bitcast_convert_type(dacc, jnp.int32)[None]], axis=0)
    return dstate, out, hr, hi


class TetraReceiver:
    def __init__(self, channels: int = 1, voice_cb=None, mode: str = "fast",
                 device_acquire: bool | None = None, mac_workers: int = 0,
                 voice: bool = False, keystore: str | None = None,
                 events: bool = True, wideband: int = 0, t50: int = 6400,
                 fleet: bool = False, wb_k: int = 1,
                 wb_pipeline: bool = False):
        """mode: "fast" = chunked-update production loops (demod_fast);
        "ff" = feedforward block receiver (demod_ff: estimate-then-apply,
        no feedback loops -- best quality floors and instant coarse-CFO
        acquisition); "exact" = per-sample reference-parity loops (demod).

        device_acquire: batch UNLOCKED-channel SYNC acquisition on device
        (one correlation call for all searching channels,
        rx.burst_sync.device_acquire_scan).  Default: on for >= 64 channels,
        where the host's per-channel scans dominate startup/dropout; below
        that the per-dispatch device overhead outweighs them.

        mac_workers: >0 shards the host MAC dispatch over that many worker
        processes (rx.hostpool.MacPool); device FEC stays batched here.  In
        pool mode use voice=True (worker-side pipelines + pool.take_audio())
        instead of voice_cb, keystore= for worker-side decryption, and
        display(c)/events come from the pooled snapshots;
        save_state/load_state are unsupported.

        events: keep the per-channel parsed-PDU event log (UpperMac.events).
        Disable for headless/bulk decode -- skips event construction and
        LLC/MLE identification whose only output is that log, and stops the
        log growing unboundedly in long runs.

        fleet: run the whole bit pipeline (burst sync + MAC dispatch +
        display state) in the native fleet engine (rx.fleet.FleetEngine):
        Python does two ctypes calls + one device FEC call per cycle
        regardless of channel count -- the production path at scale.
        Implies events=False and no crypto; voice_cb still works.

        wideband: N > 0 makes this an N x 25 kHz wideband receiver: feed
        raw antenna IQ at N*25 kHz through process_wideband() and the
        channelizer + 18/25 resampler + demod run fused in ONE device
        program per block (the bench_wideband cascade), with the
        resampler's per-channel history carried in the receiver state for
        exact stream continuity.  channels is forced to N.  t50 sets the
        per-channel 50 kHz samples per internal block (t50*18/25 must be a
        multiple of the demod chunk).

        wb_pipeline: double-buffer superblocks (see below; needs wb_k > 1)."""
        if wideband:
            channels = wideband
        self.channels = channels
        self.demod = {"fast": demod_fast, "ff": demod_ff}.get(
            mode, demod_exact)
        self.state = self.demod.demod_init(channels)
        self.phy = [PhyState() for _ in range(channels)]
        self.sync = [BurstSync(phy=p) for p in self.phy]
        self.device_acquire = (channels >= 64 if device_acquire is None
                               else device_acquire)
        self.pool = None
        self.fleet = None
        if fleet:
            from .fleet import FleetEngine
            assert not mac_workers and keystore is None, \
                "fleet mode replaces mac_workers; crypto needs the Python path"
            # FEC bucket sizing.  Wideband superblock receivers know their
            # exact cycle geometry, so the ONE mixed program's bucket sits
            # at the worst-case steady row rate (slots/cycle = t36 bits /
            # 510; with BBK rows decoded natively in the fleet engine,
            # every burst type sends <= 2 rows/slot to the device -- SYNC
            # SB1+SB2 and NORM_2's two NDBs hit exactly 2 -- plus ~10%
            # headroom); rare overflow beyond that (a post-acquisition
            # ring-backlog drain) CHUNKS over the same compiled program
            # instead of recompiling.  FEC program: the TYPED split
            # (FleetEngine default) -- SB1/NDB rows on a 144-step-trellis
            # program with 27-byte uploads and 17-byte result rows, SCH-F
            # rows on their own full-width program compiled only when
            # traffic appears (tetra_lower_mac.c:58-105 type-1 lengths).
            # The typed split halves the trellis work AND the result fetch
            # instead of merely partitioning them.
            if wideband and channels >= 64:
                slots = (t50 * 18 // 25) / 510.0
                K = max(1, wb_k)
                pad_rows = -(-int(channels * K * slots * 2.2) // 1024) * 1024
                self.fleet = FleetEngine(channels, voice_cb=voice_cb,
                                         pad_rows=pad_rows)
            else:
                # narrowband fleet feeds have caller-defined block lengths:
                # size from the historical worst-case formula
                pad_rows = 1 << max(5, (channels * 28 * max(1, wb_k)
                                        - 1).bit_length()) \
                    if channels >= 64 else 0
                self.fleet = FleetEngine(channels, voice_cb=voice_cb,
                                         pad_rows=pad_rows)
            self.mac = []
            self.sym_quality = np.zeros(channels, np.float32)
            self.wideband = wideband
            self.wb_k = max(1, wb_k)
            # double-buffered superblock pipelining (wb_pipeline=True):
            # dispatch superblock s+1 before fetching s's outputs, so device
            # compute overlaps the host bit->MAC stack and the fetch round
            # trip.  Decode state visible through
            # display()/crc_counts() lags one superblock until
            # flush_wideband().
            self.wb_pipeline = bool(wb_pipeline) and self.wb_k > 1
            self._wb_pending = None
            if wideband:
                self._init_wideband(mode, t50)
            else:
                self._cfo_primed = False
            return
        if mac_workers:
            from .hostpool import MacPool
            assert voice_cb is None, "pool mode: use voice=True instead"
            self.mac = []
            self.pool = MacPool(channels, mac_workers, voice=voice,
                                keystore=keystore, events=events)
        else:
            self.mac = [LowerMac(phy=p) for p in self.phy]
            for m in self.mac:
                m.upper.events_enabled = events
            if voice_cb is not None:
                for m in self.mac:
                    m.voice_cb = voice_cb
        self.sym_quality = np.zeros(channels, np.float32)
        self.wideband = wideband
        self.wb_k = max(1, wb_k)
        # double-buffered superblock pipelining (wb_pipeline=True): dispatch
        # superblock s+1 before fetching s's outputs, so device compute
        # overlaps the host bit->MAC stack and the fetch round trip.
        # Decode state visible through display()/crc_counts()
        # lags one superblock until flush_wideband().
        self.wb_pipeline = bool(wb_pipeline) and self.wb_k > 1
        self._wb_pending = None
        if wideband:
            self._init_wideband(mode, t50)

    def _init_wideband(self, mode: str, t50: int):
        from ..parallel import channelizer as CH
        channels = self.channels
        assert mode in ("fast",), "wideband fusion uses the fast chain"
        t36 = t50 * 18 // 25
        assert t50 % 25 == 0 and t36 % self.demod.K_SAMP == 0, (
            "t50*18/25 must be a multiple of the demod chunk")
        hop = self.wideband // 2
        L = self.wideband * CH.TAPS_PER_BRANCH
        pad = CH.RS_TAPS_PER_PHASE - 1
        self._wb = dict(
            t50=t50, t36=t36, hop=hop, L=L,
            wide_len=(t50 - 1) * hop + L, advance=t50 * hop,
            n_chunks=self.demod.n_chunks_for(t36),
            buf=np.zeros(0, np.complex64),
            hist_r=jnp.zeros((pad, channels), jnp.float32),
            hist_i=jnp.zeros((pad, channels), jnp.float32))
        # the ff-style coarse-CFO preset needs per-channel IQ the fused
        # program never exposes; the FLL pulls in from zero instead
        self._cfo_primed = True

    @staticmethod
    def coarse_cfo(iq: np.ndarray) -> np.ndarray:
        """Data-aided-free coarse CFO estimate per channel, rad/sample.

        z = x[n]*conj(x[n-2]) spans one symbol at 2 sps, so angle(z) =
        2w + dphi with dphi in {+-pi/4, +-3pi/4} (pi/4-DQPSK); z^4 collapses
        the modulation term to pi (mod 2pi), leaving angle(mean z^4) =
        8w + pi.  Unambiguous for |CFO| < fs/16 (+-2.25 kHz) -- far beyond
        real crystal offsets.  Host NumPy on the raw block: runs once per
        acquisition, no extra compiled program.  The reference has no coarse estimator;
        its FLL pulls a 900 Hz CFO in over ~0.8 s (+)."""
        zr = (iq[:, 2:] * np.conj(iq[:, :-2]))
        z4 = (zr * zr) ** 2
        m = z4.mean(axis=1)
        ang = np.angle(m)
        w = (ang - np.pi + np.pi) % (2 * np.pi) - np.pi  # wrap(ang - pi)
        return (w / 8.0).astype(np.float32)

    def process(self, iq: np.ndarray) -> None:
        """Feed one (C, T) IQ block at 36 ksps per channel."""
        iq = np.atleast_2d(iq)
        assert iq.shape[0] == self.channels
        if not getattr(self, "_cfo_primed", False):
            # one-shot acquisition assist: preset the FLL frequency from a
            # coarse estimate so pull-in starts inside the loop's linear
            # range instead of sweeping from zero (the ff chain estimates
            # its own coarse CFO in-graph every block: nothing to prime)
            self._cfo_primed = True
            if hasattr(self.state, "fll_freq"):
                est = self.coarse_cfo(np.asarray(iq, np.complex64))
                self.state = self.state._replace(fll_freq=jnp.asarray(est))
        self.state, outs = self.demod.demod_block(self.state, iq)
        self._post_demod(outs)

    def process_wideband(self, raw: np.ndarray) -> None:
        """Feed raw wideband IQ at N*25 kHz (any length; buffered
        internally).  Each full window runs channelize -> resample -> demod
        as ONE device program (see __init__ wideband)."""
        assert self.wideband, "construct with wideband=N"
        wb = self._wb
        raw = np.asarray(raw)
        if raw.dtype == np.int16:
            # SDR-native interleaved cs16: keep int16 end to end and convert
            # ON DEVICE (_wideband_step i16=True) -- halves the upload bytes
            if wb["buf"].dtype != np.int16:
                assert len(wb["buf"]) == 0, "cannot mix cs16 and cf32 feeds"
                wb["buf"] = np.zeros(0, np.int16)
            assert len(raw) % 2 == 0, "cs16 feed must be whole I/Q pairs"
            wb["buf"] = np.concatenate([wb["buf"], raw])
            i16 = True
        else:
            wb["buf"] = np.concatenate([wb["buf"],
                                        np.asarray(raw, np.complex64)])
            i16 = False
        stride = 2 if i16 else 1
        # the fleet path always uses the superblock program (time-major
        # packed output, K=1 degenerates to a length-1 scan)
        K = self.wb_k
        if self.fleet is not None:
            # superblock path: one device dispatch + one fetch per K cycles
            need = stride * ((K - 1) * wb["advance"] + wb["wide_len"])
            while len(wb["buf"]) >= need:
                if i16:
                    wins = [wb["buf"][stride * j * wb["advance"]:
                                      stride * (j * wb["advance"]
                                                + wb["wide_len"])]
                            for j in range(K)]
                    wr = jnp.asarray(np.stack(
                        [np.ascontiguousarray(w[0::2]) for w in wins]))
                    wi = jnp.asarray(np.stack(
                        [np.ascontiguousarray(w[1::2]) for w in wins]))
                else:
                    wins = [wb["buf"][j * wb["advance"]:
                                      j * wb["advance"] + wb["wide_len"]]
                            for j in range(K)]
                    wr = jnp.asarray(np.stack(
                        [np.ascontiguousarray(w.real, np.float32)
                         for w in wins]))
                    wi = jnp.asarray(np.stack(
                        [np.ascontiguousarray(w.imag, np.float32)
                         for w in wins]))
                wb["buf"] = wb["buf"][stride * K * wb["advance"]:]
                (self.state, fused, wb["hist_r"],
                 wb["hist_i"]) = _wideband_step_scan(
                    self.state, wr, wi, wb["hist_r"], wb["hist_i"],
                    self.wideband, wb["t36"], wb["n_chunks"], i16, K)
                self._consume_fused(fused)
            return
        while len(wb["buf"]) >= stride * wb["wide_len"]:  # per-cycle path
            win = wb["buf"][:stride * wb["wide_len"]]
            wb["buf"] = wb["buf"][stride * wb["advance"]:]
            if i16:
                wr = jnp.asarray(np.ascontiguousarray(win[0::2]))
                wi = jnp.asarray(np.ascontiguousarray(win[1::2]))
            else:
                wr = jnp.asarray(np.ascontiguousarray(win.real, np.float32))
                wi = jnp.asarray(np.ascontiguousarray(win.imag, np.float32))
            (self.state, outs, wb["hist_r"], wb["hist_i"]) = _wideband_step(
                self.state, wr, wi, wb["hist_r"], wb["hist_i"],
                self.wideband, wb["t36"], wb["n_chunks"], i16=i16)
            self._post_demod(outs)

    def process_wideband_staged(self, wr, wi) -> None:
        """Superblock feed from PRE-STAGED device arrays: wr/wi are
        (wb_k, wide_len) float32 (re, im) window stacks already resident in
        device memory.  This is the zero-copy ingest path for production
        pipelines where the SDR front-end DMAs sample blocks straight into
        device buffers (or an on-device ring holds them): the host never
        touches the raw IQ and the upload leaves the critical path.
        Windows must
        overlap exactly as `process_wideband` frames them: window j covers
        wide samples [j*advance, j*advance + wide_len) of the stream.

        Equivalent decode semantics to process_wideband (same jitted
        program); see scripts/bench_e2e.py --resident for the measured
        device+host stack number this path sustains."""
        assert self.wideband and self.fleet is not None, \
            "staged ingest needs wideband=N, fleet=True"
        wb = self._wb
        assert wr.shape == (self.wb_k, wb["wide_len"]), wr.shape
        (self.state, fused, wb["hist_r"],
         wb["hist_i"]) = _wideband_step_scan(
            self.state, wr, wi, wb["hist_r"], wb["hist_i"],
            self.wideband, wb["t36"], wb["n_chunks"], False, self.wb_k)
        self._consume_fused(fused)

    def _consume_fused(self, fused) -> None:
        """Hand a superblock's fused device output to the bit pipeline --
        directly, or one superblock deferred when wb_pipeline is on (the
        fetch of s then overlaps the device compute of s+1, which jax has
        already dispatched asynchronously)."""
        if not self.wb_pipeline:
            self._post_demod_fused(np.asarray(fused))
            return
        prev, self._wb_pending = self._wb_pending, fused
        if prev is not None:
            self._post_demod_fused(np.asarray(prev))

    def flush_wideband(self) -> None:
        """Drain the deferred superblock of the pipelined path (call before
        reading final state, or at end of stream)."""
        if self._wb_pending is not None:
            self._post_demod_fused(np.asarray(self._wb_pending))
            self._wb_pending = None

    def _apply_quality(self, vcount: np.ndarray, dsum: np.ndarray) -> None:
        nz = vcount > 0
        if nz.any():
            self.sym_quality[nz] = (dsum[nz] / vcount[nz]).astype(np.float32)

    def _post_demod_fused(self, fused: np.ndarray) -> None:
        """Superblock output of _wideband_step_scan: (K*G + 2, C) int32 in
        the pack_cycle_tc layout; the last two rows carry the f32-bitcast
        per-channel vcount/dsum quality sums."""
        vcount = fused[-2].copy().view(np.float32)
        dsum = fused[-1].copy().view(np.float32)
        self._apply_quality(vcount, dsum)
        self._const = None
        self.fleet.process_packed2(fused[:-2], self.wb_k,
                                   self._wb["n_chunks"])

    def _post_demod(self, outs) -> None:
        """Shared bit pipeline: demod outputs -> burst sync -> batched
        FEC/MAC dispatch."""
        if "packed" in outs:
            # transfer-lean fleet path (_wideband_step pack=True): one
            # packed byte per symbol slot + per-channel quality sums
            packed = np.asarray(outs["packed"])
            vcount = np.asarray(outs["vcount"])
            dsum = np.asarray(outs["dsum"])
            self._apply_quality(vcount, dsum)
            self._const = None
            self.fleet.process_packed(packed)
            return
        dibits = np.asarray(outs["dibits"])
        valid = np.asarray(outs["valid"])
        dist = np.asarray(outs["dist"])
        # constellation tap (reference: splitter->reshaper->GUI buffer,
        # main.cpp:85-89); kept as device arrays, fetched only on demand
        self._const = (outs["sym_re"], outs["sym_im"], valid)
        if self.fleet is not None:
            # fleet path: vectorized quality + the native engine's
            # two-ctypes-calls-plus-one-device-call pipeline
            v = valid.astype(bool)
            cnt = v.sum(axis=1)
            nz = cnt > 0
            if nz.any():
                s = np.where(v, dist, 0.0).sum(axis=1)
                self.sym_quality[nz] = (s[nz] / cnt[nz]).astype(np.float32)
            self.fleet.process(dibits, valid.astype(np.uint8))
            return
        # burst sync per channel (host), then ONE cross-channel batched FEC
        # pass: device-call count stays constant as channels grow
        feeds: dict[int, np.ndarray] = {}
        for c in range(self.channels):
            v = valid[c]
            if not v.any():
                continue
            self.sym_quality[c] = float(dist[c][v].mean())
            feeds[c] = demod_exact.dibits_to_bits(dibits[c][v])
        if self.device_acquire:
            from .burst_sync import RX_UNLOCKED, device_acquire_scan
            searching = [c for c in feeds
                         if self.sync[c].state == RX_UNLOCKED]
            if searching:
                device_acquire_scan([self.sync[c] for c in searching],
                                    [feeds[c] for c in searching],
                                    pad_channels=self.channels)
        if self.pool is not None:
            chan_ids, phys, bursts_list = [], [], []
            for c, bits in feeds.items():
                bursts = self.sync[c].feed(bits)
                if bursts:
                    chan_ids.append(c)
                    phys.append(self.phy[c])
                    bursts_list.append(bursts)
            if chan_ids:
                self.pool.process_bursts(phys, chan_ids, bursts_list)
            return
        macs, bursts_list = [], []
        for c, bits in feeds.items():
            bursts = self.sync[c].feed(bits)
            if bursts:
                macs.append(self.mac[c])
                bursts_list.append(bursts)
        if macs:
            process_bursts_multi(macs, bursts_list)

    # -- convenience views ---------------------------------------------------

    def display(self, c: int = 0):
        if self.fleet is not None:
            return self.fleet.display(c)
        if self.pool is not None:
            from .display import DisplayState
            d = self.pool.views[c].display
            return DisplayState(**d) if d else DisplayState()
        return self.mac[c].upper.display

    def locked(self, c: int = 0) -> bool:
        from .burst_sync import RX_LOCKED
        if self.fleet is not None:
            return self.fleet.locked(c)
        return self.sync[c].state == RX_LOCKED

    def constellation(self, c: int = 0, n: int = 256):
        """(re, im) of the last block's final n valid post-Costas symbols
        (the reference's 1024-point constellation tap, main.cpp:376-383)."""
        if getattr(self, "_const", None) is None:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        sym_re, sym_im, valid = self._const
        v = valid[c].astype(bool)
        re = np.asarray(sym_re)[c][v][-n:]
        im = np.asarray(sym_im)[c][v][-n:]
        return re, im

    def crc_counts(self, c: int = 0) -> tuple[int, int]:
        """(crc_oks, crc_fails) — works in both in-process and pool modes."""
        if self.fleet is not None:
            return self.fleet.crc_counts(c)
        if self.pool is not None:
            v = self.pool.views[c]
            return v.crc_oks, v.crc_fails
        return self.mac[c].crc_oks, self.mac[c].crc_fails

    def quality_ok(self, c: int = 0) -> bool:
        """Signal-quality gate analogous to dqpsk_sym_extr.cpp:25-29."""
        from .. import params as P
        return self.sym_quality[c] < P.SYNC_QUALITY_THRESHOLD

    # -- checkpoint / resume -------------------------------------------------
    # The reference has no state persistence at all (SURVEY.md section 5:
    # "DSP/decoder state is ephemeral").  For long-running production
    # receivers we checkpoint the resumable signal-path state: demod loop
    # state, burst-sync lock + bit buffer, TDMA time, and each channel's
    # cell data (scrambling).  Event logs and fragment slots are transient
    # by design (fragments age out after N203 multiframes anyway) and are
    # not part of the checkpoint.

    def save_state(self, path: str) -> None:
        if self.fleet is not None:
            # fleet mode: demod loop state + the native engine's raw
            # channel-state blob (FleetEngine.state_bytes) + wideband
            # stream continuity
            data = {}
            for k, v in self.state._asdict().items():
                data[f"demod_{k}"] = np.asarray(v)
            data["fleet_blob"] = np.frombuffer(self.fleet.state_bytes(),
                                               np.uint8)
            data["sym_quality"] = self.sym_quality
            if self.wideband:
                data["wb_buf"] = self._wb["buf"]
                data["wb_hist_r"] = np.asarray(self._wb["hist_r"])
                data["wb_hist_i"] = np.asarray(self._wb["hist_i"])
            np.savez(path, **data)
            return
        if self.pool is not None:
            raise NotImplementedError("checkpointing unsupported in "
                                      "mac_workers pool mode")
        data = {}
        for k, v in self.state._asdict().items():
            data[f"demod_{k}"] = np.asarray(v)
        for c in range(self.channels):
            s, m = self.sync[c], self.mac[c]
            t = s.phy.time
            data[f"sync{c}"] = np.array([
                s.state, s.bitbuf_start_bitnum, s.next_frame_start_bitnum,
                s.lock_losses, s.phy.slot_count,
                t.hn, t.mn, t.fn, t.tn, t.sn], np.int64)
            data[f"bitbuf{c}"] = s.bitbuf
            data[f"cell{c}"] = np.array([
                m.cell.mcc, m.cell.mnc, m.cell.colour_code,
                m.cell.scramb_init, m.crc_oks, m.crc_fails], np.int64)
        data["sym_quality"] = self.sym_quality
        if self.wideband:
            data["wb_buf"] = self._wb["buf"]
            data["wb_hist_r"] = np.asarray(self._wb["hist_r"])
            data["wb_hist_i"] = np.asarray(self._wb["hist_i"])
        np.savez(path, **data)

    def load_state(self, path: str) -> None:
        import jax.numpy as jnp
        z = np.load(path)
        fields = {k[len("demod_"):]: jnp.asarray(z[k])
                  for k in z.files if k.startswith("demod_")}
        self.state = type(self.state)(**fields)
        if self.fleet is not None:
            assert "fleet_blob" in z.files, "not a fleet-mode checkpoint"
            self.fleet.load_state_bytes(z["fleet_blob"].tobytes())
            self.sym_quality = z["sym_quality"]
            if self.wideband and "wb_hist_r" in z.files:
                self._wb["buf"] = z["wb_buf"].astype(np.complex64) \
                    if z["wb_buf"].dtype != np.int16 else z["wb_buf"]
                self._wb["hist_r"] = jnp.asarray(z["wb_hist_r"])
                self._wb["hist_i"] = jnp.asarray(z["wb_hist_i"])
            self._cfo_primed = True
            return
        for c in range(self.channels):
            s, m = self.sync[c], self.mac[c]
            (s.state, s.bitbuf_start_bitnum, s.next_frame_start_bitnum,
             s.lock_losses, s.phy.slot_count,
             hn, mn, fn, tn, sn) = (int(x) for x in z[f"sync{c}"])
            t = s.phy.time
            t.hn, t.mn, t.fn, t.tn, t.sn = hn, mn, fn, tn, sn
            s.bitbuf = z[f"bitbuf{c}"].astype(np.uint8)
            # scan bookkeeping restarts from the buffer head (safe: merely
            # rescans the restored buffer once)
            s.scan_from = s.bitbuf_start_bitnum
            s.pending_scan = None
            (m.cell.mcc, m.cell.mnc, m.cell.colour_code,
             m.cell.scramb_init, m.crc_oks, m.crc_fails) = (
                int(x) for x in z[f"cell{c}"])
            d = m.upper.display
            d.mcc, d.mnc, d.cc = m.cell.mcc, m.cell.mnc, m.cell.colour_code
        self.sym_quality = z["sym_quality"]
        if self.wideband and "wb_hist_r" in z.files:
            self._wb["buf"] = z["wb_buf"].astype(np.complex64)
            self._wb["hist_r"] = jnp.asarray(z["wb_hist_r"])
            self._wb["hist_i"] = jnp.asarray(z["wb_hist_i"])
        # restored FLL state must not be clobbered by the coarse-CFO preset
        self._cfo_primed = True
