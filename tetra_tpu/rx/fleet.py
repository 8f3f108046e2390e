"""Fleet receiver engine: native multi-channel bit pipeline around the
batched device FEC.

Python's per-cycle work in this path is TWO ctypes calls plus ONE device
call, independent of channel count:

    fleet_feed      (C++)  (C,T) dibits+valid -> burst sync -> type-5 rows
    decode_rows_mixed (device)  all rows' FEC in one program
    fleet_dispatch  (C++)  decoded rows -> per-channel MAC/display state

Semantics are exactly the Python pipeline's (rx/burst_sync.BurstSync +
rx/lower_mac.LowerMac in the production no-event/no-crypto configuration);
tests/test_fleet.py asserts lock/display/CRC parity on mixed fuzz streams.
The native engine lives in rx/native/fleet.cpp (built with macparse.cpp).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import native_build
from .. import params as P
from . import fec as rx_fec
from .display import DisplayState
from .native_mac import MacStateStruct
from .tdma import TdmaTime

_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_DIR, "fleet.cpp")
_SRC_DEP = os.path.join(_DIR, "macparse.cpp")

_lib = None
_lock = threading.Lock()

_T5P_BYTES, _T1P_BYTES, _META_COLS = 54, 34, 12
_KS_SLOTS = 16

# display flag order (Disp.flags in fleet.cpp = BS_SERVICE_FLAGS minus the
# reserved slot)
_DISP_FLAGS = ("advanced_link", "air_encryption", "sndcp_data",
               "circuit_data", "voice_service", "normal_mode",
               "migration_supported", "never_minimum_mode", "priority_cell",
               "dereg_mandatory", "reg_mandatory")


class _TTime(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in ("hn", "mn", "fn", "tn", "sn")]


class _Disp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int64) for n in
                 ("curr_hyperframe", "curr_multiframe", "curr_frame")]
                + [("timeslot_content", ctypes.c_int64 * 4)]
                + [(n, ctypes.c_int64) for n in
                   ("dl_usage", "ul_usage", "access1_code", "access2_code",
                    "access1", "access2", "dl_freq", "ul_freq", "mcc", "mnc",
                    "cc", "last_crc_fail")]
                + [("flags", ctypes.c_int64 * 11)])


class FleetChanStruct(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in
                ("state", "start_bitnum", "next_frame", "scan_from",
                 "lock_losses", "buf_len")] + [
        ("time", _TTime), ("slot_count", ctypes.c_int64),
        ("cell_mcc", ctypes.c_int64), ("cell_mnc", ctypes.c_int64),
        ("cell_cc", ctypes.c_int64), ("scramb_init", ctypes.c_int64),
        ("cell_time", _TTime),
        ("crc_oks", ctypes.c_int64), ("crc_fails", ctypes.c_int64),
        ("disp", _Disp), ("mac", MacStateStruct),
        ("ks_scramb", ctypes.c_int64), ("ks30", ctypes.c_uint8 * 30),
        ("buf", ctypes.c_uint8 * (1 << 16)),
    ]


def build_library(out_dir: str = native_build.BUILD_DIR) -> str:
    """Compile fleet.cpp (+ the macparse.cpp it includes) into out_dir;
    returns the library path."""
    return native_build.build(
        "tetra_fleet", _SRC, deps=(_SRC_DEP,),
        flags=("-O2", "-std=c++17", "-pthread", "-I", _DIR), out_dir=out_dir)


def load():
    """Build (on first use) and load the native fleet library.  None only
    when disabled via TETRA_NO_NATIVE_MAC (the fleet path is native-only, so
    disabling the native MAC disables it too); a failed build or load
    raises."""
    global _lib
    if os.environ.get("TETRA_NO_NATIVE_MAC"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.fleet_create.restype = ctypes.c_void_p
        lib.fleet_create.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64]
        lib.fleet_destroy.argtypes = [ctypes.c_void_p]
        lib.fleet_chan_size.restype = ctypes.c_int64
        lib.fleet_chan_ptr.restype = ctypes.c_void_p
        lib.fleet_chan_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fleet_scramb_ptr.restype = ctypes.c_void_p
        lib.fleet_scramb_ptr.argtypes = [ctypes.c_void_p]
        lib.fleet_feed.restype = ctypes.c_int64
        lib.fleet_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.fleet_feed_sb.restype = ctypes.c_int64
        lib.fleet_feed_sb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.fleet_dispatch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.fleet_set_rm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.fleet_rm_redecode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.fleet_set_threads.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int64]
        if lib.fleet_chan_size() != ctypes.sizeof(FleetChanStruct):
            raise RuntimeError(
                f"fleet ABI mismatch: {lib.fleet_chan_size()} != "
                f"{ctypes.sizeof(FleetChanStruct)}")
        _lib = lib
        return lib


class FleetEngine:
    """Owns the native per-channel state for `channels` channels."""

    def __init__(self, channels: int, voice_cb=None, pad_rows: int = 0,
                 cch_bucket: int = 0, bbk_bucket: int = 0,
                 split_fec: bool = False, typed_fec: bool = True,
                 short_bucket: int = 0, schf_bucket: int = 0,
                 threads: int | None = None):
        """threads: worker threads for the native per-channel loops
        (fleet_feed/fleet_feed_sb/fleet_dispatch; channels are fully
        independent and ctypes releases the GIL, so workers use real
        cores).  None = TETRA_FLEET_THREADS env; 0 = auto (cores-1, one
        core stays with the device-dispatch loop); 1 = sequential.
        Bit-exact vs sequential (tests/test_fleet.py)."""
        lib = load()
        if lib is None:
            raise RuntimeError("native fleet engine disabled "
                               "(TETRA_NO_NATIVE_MAC)")
        self.lib = lib
        self.channels = channels
        self.voice_cb = voice_cb
        if threads is None:
            threads = int(os.environ.get("TETRA_FLEET_THREADS", "0"))
        if threads == 0:
            threads = max(1, (os.cpu_count() or 2) - 1)
        # pad the per-cycle FEC batch to one fixed bucket: a steady-state
        # receiver then compiles exactly one mixed-decode program
        # (rx/fec.decode_rows_mixed)
        self.pad_rows = pad_rows
        # FEC program choice (precedence: split > typed > mixed):
        #   typed (DEFAULT): per-length programs -- SB1/NDB rows pay a
        #     144-step trellis and 27/17-byte transfers, SCH-F rows their
        #     full 288/54/35-byte forms (compiled only if traffic appears).
        #     Halves the FEC result fetch AND the trellis work on
        #     signalling-heavy traffic.
        #   split (legacy, explicit): CCH-vs-BBK split at full width.
        #   mixed: the single all-variant program (the sharded path's ABI).
        self.split_fec = split_fec
        self.typed_fec = typed_fec and not split_fec
        # zero buckets would derive the device batch shape from the LIVE
        # row count (a recompile whenever the per-cycle count crosses a
        # 256 boundary): default every bucket to a fixed steady-state size
        # -- pad_rows when the caller sized it, else 1024 rows (chunking
        # covers overflow on the same compiled program)
        if split_fec:
            cch_bucket = cch_bucket or pad_rows or 1024
            bbk_bucket = bbk_bucket or max(512, pad_rows // 4)
        self.cch_bucket = cch_bucket
        self.bbk_bucket = bbk_bucket
        if self.typed_fec:
            # short rows are <= 2/slot (every burst type), SCH-F <= 1/slot.
            # Default: ONE chunk per steady-state batch.  Smaller buckets
            # chunk a batch, and decode_rows_typed_packed dispatches all
            # chunks before fetching any, overlapping chunk j+1's
            # upload+trellis with chunk j's fetch.
            short_bucket = short_bucket or pad_rows or 1024
            schf_bucket = schf_bucket or max(512, pad_rows // 2)
        self.short_bucket = short_bucket
        self.schf_bucket = schf_bucket
        y = np.ascontiguousarray(P.TRAIN_Y, np.uint8)
        n = np.ascontiguousarray(P.TRAIN_N, np.uint8)
        p = np.ascontiguousarray(P.TRAIN_P, np.uint8)
        self.h = lib.fleet_create(
            channels, y.ctypes.data, len(y), n.ctypes.data, len(n),
            p.ctypes.data, len(p), P.SCRAMB_INIT)
        # local BBK decode (syndrome RM(30,14), bit-exact to the device
        # ML-with-dist<=3): BBK rows (~1/3 of every batch) never cross the
        # device link
        parity = np.ascontiguousarray(P.RM3014_PARITY, np.uint8)
        tapmask = 0
        for t in P.SCRAMB_TAPS:
            tapmask |= 1 << (32 - t)
        lib.fleet_set_rm(self.h, parity.ctypes.data, tapmask)
        if threads != 1:
            lib.fleet_set_threads(self.h, threads)  # 0 = hw concurrency
        self.scramb = np.ctypeslib.as_array(
            ctypes.cast(lib.fleet_scramb_ptr(self.h),
                        ctypes.POINTER(ctypes.c_int64)), (channels,))
        self._chans = [FleetChanStruct.from_address(
            lib.fleet_chan_ptr(self.h, c)) for c in range(channels)]
        self._cap = 0
        self._t5 = self._meta = None
        # device keystream table (rx/fec.decode_rows_mixed_packed): slot 0 =
        # SCRAMB_INIT, other slots assigned cycle-locally
        self._ks_host = np.zeros((_KS_SLOTS, 432), np.uint8)
        self._ks_host[0] = rx_fec.keystream(P.SCRAMB_INIT, 432)
        self._ks_slot_scramb = np.full(_KS_SLOTS, -1, np.int64)
        self._ks_slot_scramb[0] = P.SCRAMB_INIT
        self._ks_dev = None

    def __del__(self):
        try:
            self.lib.fleet_destroy(self.h)
        except Exception:
            pass

    # -- per-cycle pipeline ------------------------------------------------

    def process(self, dibits: np.ndarray, valid: np.ndarray) -> int:
        """One feed cycle from separate dibit/valid arrays (packs on the
        host; the receiver's device path delivers pre-packed bytes to
        process_packed directly)."""
        packed = ((np.asarray(dibits, np.uint8) & 3)
                  | (np.asarray(valid, np.uint8) << 7))
        return self.process_packed(packed)

    def _ks_cycle_map(self, scrambs: np.ndarray):
        """Cycle-local scrambling-code -> keystream-table-slot mapping.
        Slot 0 is always SCRAMB_INIT; this cycle's other distinct codes get
        slots 1..15.  Returns (idx array per row, ok) -- ok False when the
        cycle somehow carries > 15 distinct non-init codes (the caller
        falls back to the unpacked path)."""
        uniq = [int(u) for u in np.unique(scrambs) if int(u) != P.SCRAMB_INIT]
        if len(uniq) >= _KS_SLOTS:
            return None, False
        slot_of = {P.SCRAMB_INIT: 0}
        dirty = False
        for u in uniq:
            slot = slot_of[u] = len(slot_of)
            if self._ks_slot_scramb[slot] != u:
                self._ks_host[slot] = rx_fec.keystream(u, 432)
                self._ks_slot_scramb[slot] = u
                dirty = True
        if dirty or self._ks_dev is None:
            import jax.numpy as jnp
            self._ks_dev = jnp.asarray(self._ks_host)
        lut = np.zeros(len(slot_of), np.int32)
        keys = np.fromiter(slot_of.keys(), np.int64)
        vals = np.fromiter(slot_of.values(), np.int32)
        order = np.argsort(keys)
        pos = np.searchsorted(keys[order], scrambs)
        return vals[order][pos], True

    def process_packed(self, packed: np.ndarray) -> int:
        """One feed cycle: (C, T) packed symbol bytes (bit 7 = valid,
        bits 1:0 = dibit) -> burst sync -> device FEC -> MAC dispatch.
        Returns the number of blocks decoded."""
        return self.process_packed_cycles(packed[None])

    def _ensure_rowbufs(self, K: int, T: int) -> None:
        # worst case: the whole per-channel ring backlog (FLEET_BUFCAP =
        # 1<<16 bits) drains in one call on top of the fed bits
        cap = self.channels * (
            (K * T * 2 + (1 << 16)) // P.BITS_PER_TS + 2 * K) * 3
        if cap > self._cap:
            self._cap = cap
            self._t5 = np.empty((cap, _T5P_BYTES), np.uint8)
            self._meta = np.empty((cap, _META_COLS), np.int64)

    def process_packed_cycles(self, packed_k: np.ndarray) -> int:
        """K feed cycles at once: (K, C, T) packed symbol bytes in the
        channel-major per-cycle layout.  Runs K native burst-sync feeds
        back to back, then ONE batched device FEC decode and ONE native MAC
        dispatch over all emitted rows; dispatch semantics equal feeding
        the cycles one by one (rows stay in chronological order per
        channel)."""
        K, C, T = packed_k.shape
        assert C == self.channels
        self._ensure_rowbufs(K, T)
        n = 0
        for j in range(K):
            pj = np.ascontiguousarray(packed_k[j], np.uint8)
            n += self.lib.fleet_feed(
                self.h, pj.ctypes.data, T,
                self._t5[n:].ctypes.data, self._meta[n:].ctypes.data,
                self._cap - n)
            assert n <= self._cap, "fleet_feed capacity overflow"
        return self._decode_dispatch(n, K)

    def process_packed2(self, words: np.ndarray, K: int,
                        n_chunks: int) -> int:
        """K feed cycles from the superblock's TIME-MAJOR device output
        (rx/receiver.pack_cycle_tc layout): words (K*G, C) int32,
        cycle-major rows; each cycle = Tp/16 symbol rows (16 two-bit dibit
        fields per int32) followed by ceil(n_chunks/4) count rows (4
        8-bit per-chunk valid counts per int32).  The C++ engine reads the
        streams directly (fleet_feed_sb) -- no host-side transpose or
        unpack.  Semantics equal K process_packed calls on the unpacked
        channel-major bytes (tests/test_fleet.py)."""
        R, C = words.shape
        assert C == self.channels and R % K == 0
        sym_words = n_chunks * 2      # K_SYM=32 -> 2 int32 words per chunk
        cnt_words = -(-n_chunks // 4)
        assert R // K == sym_words + cnt_words, (R // K, sym_words,
                                                 cnt_words)
        self._ensure_rowbufs(K, sym_words * 16)
        words = np.ascontiguousarray(words, np.int32)
        n = int(self.lib.fleet_feed_sb(
            self.h, words.ctypes.data, K, n_chunks,
            self._t5.ctypes.data, self._meta.ctypes.data, self._cap))
        assert n <= self._cap, "fleet_feed_sb capacity overflow"
        return self._decode_dispatch(n, K)

    def _decode_dispatch(self, n: int, K: int) -> int:
        """Shared back half: (already-emitted) type-5 rows -> one device
        FEC call -> native MAC dispatch -> deferred voice callbacks."""
        if n == 0:
            return 0
        if K > 1:
            # restore channel-major row order (one dispatch run per channel,
            # so the SYNC-resync restamp spans the whole superblock exactly
            # as the single-call feed did); stable sort keeps each channel's
            # rows chronological
            order = np.argsort(self._meta[:n, 0], kind="stable")
            self._t5[:n] = self._t5[:n][order]
            self._meta[:n] = self._meta[:n][order]
        meta = self._meta[:n]
        t5p = self._t5[:n]
        chans = meta[:, 0]
        blk_types = meta[:, 1]
        scrambs = self.scramb[chans]

        def decode(rows_t5p, rows_types, rows_scrambs):
            idx, ok = self._ks_cycle_map(rows_scrambs)
            if ok:
                if self.split_fec:
                    return rx_fec.decode_rows_split_packed(
                        rows_t5p, rows_types, idx, self._ks_dev,
                        cch_bucket=self.cch_bucket,
                        bbk_bucket=self.bbk_bucket)
                if self.typed_fec:
                    return rx_fec.decode_rows_typed_packed(
                        rows_t5p, rows_types, idx, self._ks_dev,
                        short_bucket=self.short_bucket,
                        schf_bucket=self.schf_bucket,
                        bbk_bucket=self.bbk_bucket or 512)
                return rx_fec.decode_rows_mixed_packed(
                    rows_t5p, rows_types, idx, self._ks_dev,
                    min_bucket=self.pad_rows)
            # >15 distinct cells in one cycle: unpacked fallback
            t5u = np.unpackbits(rows_t5p, axis=1)[:, :432]
            t1u, oku = rx_fec.decode_rows_mixed(t5u, rows_types,
                                                rows_scrambs,
                                                min_bucket=self.pad_rows)
            t1pad = np.concatenate(
                [t1u, np.zeros((len(t1u), _T1P_BYTES * 8 - t1u.shape[1]),
                               np.uint8)], axis=1)
            return np.packbits(t1pad, axis=1), oku

        # BBK rows are decoded LOCALLY at feed time (syndrome RM(30,14) in
        # fleet.cpp, bit-exact vs the device ML decode inside its
        # bounded-distance radius): meta[11] = info14 | ok<<14 | 1<<15.
        # Only the remaining rows go to the device program -- they were
        # ~1/3 of every batch and of its dominant output fetch.
        local = (meta[:, 11] & 0x8000) != 0

        def fill_local(rows, type1p, ok):
            vals = meta[rows, 11]
            info = (vals & 0x3FFF).astype(np.int64)
            type1p[rows] = 0
            type1p[rows, 0] = (info >> 6).astype(np.uint8)
            type1p[rows, 1] = ((info & 63) << 2).astype(np.uint8)
            ok[rows] = ((vals >> 14) & 1).astype(bool)

        if local.any():
            type1p = np.zeros((n, _T1P_BYTES), np.uint8)
            ok = np.zeros(n, bool)
            didx = np.nonzero(~local)[0]
            if len(didx):
                t1d, okd = decode(t5p[didx], blk_types[didx], scrambs[didx])
                type1p[didx] = t1d
                ok[didx] = okd
            fill_local(np.nonzero(local)[0], type1p, ok)
        else:
            type1p, ok = decode(t5p, blk_types, scrambs)

        # adopt each channel's first good SYNC PDU scrambling code and
        # re-decode rows decoded under a stale code (exactly
        # rx/lower_mac.decode_bursts_multi's two-phase flow)
        sb1 = (blk_types == P.TPSAP_T_SB1) & ok
        if sb1.any():
            rows = np.nonzero(sb1)[0]
            t1s = np.unpackbits(type1p[rows], axis=1)
            mcc = t1s[:, 31:41] @ (1 << np.arange(9, -1, -1))
            mnc = t1s[:, 41:55] @ (1 << np.arange(13, -1, -1))
            cc = t1s[:, 4:10] @ (1 << np.arange(5, -1, -1))
            new_scr = ((cc | (mnc << 6) | (mcc << 20)) << 2) | P.SCRAMB_INIT
            redo = np.zeros(n, bool)
            adopted: dict[int, int] = {}
            for r, sc in zip(rows, new_scr):
                c = int(chans[r])
                if c not in adopted:
                    adopted[c] = int(sc)
            for c, sc in adopted.items():
                if sc != int(self.scramb[c]):
                    redo |= (chans == c) & (blk_types != P.TPSAP_T_SB1)
                    scrambs[chans == c] = sc
            if redo.any():
                # locally-decoded BBK rows redo natively under the adopted
                # code; the rest go back to the device program
                bidx = np.nonzero(redo & local)[0]
                if len(bidx):
                    tb = np.ascontiguousarray(t5p[bidx])
                    sb = np.ascontiguousarray(scrambs[bidx], np.int64)
                    out64 = np.empty(len(bidx), np.int64)
                    self.lib.fleet_rm_redecode(self.h, tb.ctypes.data,
                                               sb.ctypes.data, len(bidx),
                                               out64.ctypes.data)
                    meta[bidx, 11] = out64 | 0x8000
                    fill_local(bidx, type1p, ok)
                ridx = np.nonzero(redo & ~local)[0]
                if len(ridx):
                    t1r, okr = decode(t5p[ridx], blk_types[ridx],
                                      scrambs[ridx])
                    type1p[ridx] = t1r
                    ok[ridx] = okr

        actions = np.empty(n, np.uint8)
        times = np.empty((n, 5), np.int64)
        okb = np.ascontiguousarray(ok, np.uint8)
        type1p = np.ascontiguousarray(type1p)
        self.lib.fleet_dispatch(self.h, type1p.ctypes.data, okb.ctypes.data,
                                meta.ctypes.data, n,
                                int(self.voice_cb is not None),
                                int(getattr(self.voice_cb, "half", None)
                                    is not None),
                                actions.ctypes.data, times.ctypes.data)
        if self.voice_cb is not None and actions.any():
            half_cb = getattr(self.voice_cb, "half", None)
            for i in np.nonzero(actions)[0]:
                c = int(chans[i])
                t345 = int(meta[i, 10])
                type5 = np.unpackbits(t5p[i])[:t345]
                type4 = type5 ^ rx_fec.keystream(int(self.scramb[c]), t345)
                # times[i] carries the restamped TDMA time (post-SB1-resync),
                # exactly what the Python path hands its voice callbacks
                t = TdmaTime(*(int(v) for v in times[i]))
                if actions[i] == 1:
                    self.voice_cb(t, type4)
                else:
                    half_cb(t, type4)
        return int(n)

    # -- checkpoint ----------------------------------------------------------

    def state_bytes(self) -> bytes:
        """Serialize every channel's native state (burst sync, PHY time,
        cell, MAC flags, display, bit ring) as the raw struct bytes.  The
        struct layout is process-stable (fixed int64/uint8 fields, no
        pointers), so the blob restores into any engine of the same
        channel count."""
        return b"".join(bytes(self._chans[c]) for c in range(self.channels))

    def load_state_bytes(self, data: bytes) -> None:
        sz = ctypes.sizeof(FleetChanStruct)
        assert len(data) == sz * self.channels, (len(data), sz, self.channels)
        for c in range(self.channels):
            ctypes.memmove(ctypes.addressof(self._chans[c]),
                           data[c * sz:(c + 1) * sz], sz)
            self.scramb[c] = self._chans[c].scramb_init

    # -- views ---------------------------------------------------------------

    def chan(self, c: int) -> FleetChanStruct:
        return self._chans[c]

    def display(self, c: int) -> DisplayState:
        d = self._chans[c].disp
        return DisplayState(
            curr_hyperframe=d.curr_hyperframe,
            curr_multiframe=d.curr_multiframe, curr_frame=d.curr_frame,
            timeslot_content=list(d.timeslot_content),
            dl_usage=d.dl_usage, ul_usage=d.ul_usage,
            access1_code=chr(d.access1_code) if d.access1_code else "",
            access2_code=chr(d.access2_code) if d.access2_code else "",
            access1=d.access1, access2=d.access2,
            dl_freq=d.dl_freq, ul_freq=d.ul_freq,
            mcc=d.mcc, mnc=d.mnc, cc=d.cc,
            last_crc_fail=bool(d.last_crc_fail),
            **{name: bool(d.flags[i]) for i, name in enumerate(_DISP_FLAGS)})

    def locked(self, c: int) -> bool:
        return self._chans[c].state == 2

    def crc_counts(self, c: int) -> tuple[int, int]:
        ch = self._chans[c]
        return int(ch.crc_oks), int(ch.crc_fails)

    def phy_time(self, c: int) -> TdmaTime:
        t = self._chans[c].time
        return TdmaTime(t.hn, t.mn, t.fn, t.tn, t.sn)

    def lock_losses(self, c: int) -> int:
        return int(self._chans[c].lock_losses)
