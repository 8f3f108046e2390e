"""Batched RX FEC stages: descramble, deinterleave, depuncture, CRC, RM3014.

Batched re-design of the reference's per-burst scalar pipeline
(lower_mac/tetra_lower_mac.c:184-237): every stage is a fixed-shape gather /
scatter / GF(2) matmul over a batch of blocks, so whole seconds of air
interface (all channels x all bursts) decode in one device call.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..tx import fec_enc
from .viterbi import viterbi_decode

# ---------------------------------------------------------------------------
# Scrambling (type-5 -> type-4): XOR with precomputed keystream
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def keystream(lfsr_init: int, length: int) -> np.ndarray:
    # maxsize must exceed (cells x block lengths) in flight: a 256-channel
    # receiver with per-channel cells thrashed the old 64-entry cache,
    # putting scramb_keystream back on the hot path every batch
    return fec_enc.scramb_keystream(lfsr_init, length)


def descramble(bits: jnp.ndarray, lfsr_init: int) -> jnp.ndarray:
    """bits: (..., L) uint8; scrambling is a self-inverse XOR."""
    ks = jnp.asarray(keystream(int(lfsr_init), bits.shape[-1]))
    return bits ^ ks


# ---------------------------------------------------------------------------
# Deinterleave (type-4 -> type-3): out[i] = in[k(i)]
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _deinterleave_idx(K: int, a: int) -> np.ndarray:
    return P.interleave_indices(K, a)


def deinterleave(bits: jnp.ndarray, a: int) -> jnp.ndarray:
    idx = jnp.asarray(_deinterleave_idx(bits.shape[-1], a))
    return bits[..., idx]


# ---------------------------------------------------------------------------
# Depuncture (type-3 -> soft mother symbols)
# ---------------------------------------------------------------------------


def depuncture_soft(bits: jnp.ndarray, punct_id: int, mother_len: int,
                    n_out: int) -> jnp.ndarray:
    """Hard type-3 bits (..., L) -> soft mother (..., mother_len//n_out, n_out).

    Non-transmitted positions get soft 0 (erasure), transmitted positions get
    +1 for bit 0 / -1 for bit 1 (viterbi.c:6-25 convention).
    """
    idx = jnp.asarray(P.puncture_indices(punct_id, bits.shape[-1]))
    soft_vals = 1.0 - 2.0 * bits.astype(jnp.float32)
    mother = jnp.zeros(bits.shape[:-1] + (mother_len,), jnp.float32)
    mother = mother.at[..., idx].set(soft_vals)
    return mother.reshape(bits.shape[:-1] + (mother_len // n_out, n_out))


# ---------------------------------------------------------------------------
# CRC-16 as a GF(2) affine map (batched check)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _crc_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M, r0): crc(bits) = (bits @ M) xor r0, bitwise over GF(2).

    M has shape (length, 16) with M[i] = crc(e_i) ^ crc(0); r0 = crc(0).
    Row vectors store the CRC MSB-first.
    """
    def crc_to_bits(c):
        return np.array([(c >> (15 - i)) & 1 for i in range(16)], np.uint8)

    zero = np.zeros(length, np.uint8)
    r0 = fec_enc.crc16_bits(zero)
    M = np.empty((length, 16), np.uint8)
    for i in range(length):
        e = zero.copy()
        e[i] = 1
        M[i] = crc_to_bits(fec_enc.crc16_bits(e) ^ r0)
    return M, crc_to_bits(r0)


def crc16_check(bits: jnp.ndarray) -> jnp.ndarray:
    """Batched good-residue check over (..., L) bit arrays.

    Returns (...,) bool: True when the CRC residue equals TETRA_CRC_OK
    (0x1d0f), i.e. the block at lower_mac/tetra_lower_mac.c:217-229 passes.
    """
    L = bits.shape[-1]
    M, r0 = _crc_matrix(L)
    good = np.array([(P.CRC16_GOOD >> (15 - i)) & 1 for i in range(16)], np.uint8)
    residue = (bits.astype(jnp.int32) @ jnp.asarray(M, jnp.int32)) % 2
    residue = residue ^ jnp.asarray(r0, jnp.int32)
    return jnp.all(residue == jnp.asarray(good, jnp.int32), axis=-1)


# ---------------------------------------------------------------------------
# RM(30,14) broadcast block
# ---------------------------------------------------------------------------

_RM_FULL = np.concatenate([np.eye(14, dtype=np.uint8), P.RM3014_PARITY], axis=1)


@lru_cache(maxsize=1)
def _rm_codebook_pm1() -> np.ndarray:
    """(30, 16384) ±1 image of every RM(30,14) codeword, column i encoding
    info word i (MSB-first).  The measured minimum distance of the code is
    8 (tests assert it), so nearest-codeword decoding corrects any <= 3 bit
    errors unambiguously."""
    info = ((np.arange(1 << 14)[:, None] >> np.arange(13, -1, -1)) & 1)
    cw = np.concatenate([info, (info @ P.RM3014_PARITY) % 2], axis=1)
    return np.ascontiguousarray((1.0 - 2.0 * cw).T.astype(np.float32))


def rm3014_decode(bits30: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., 30) coded bits -> ((..., 14) info bits, (...,) ok).

    Maximum-likelihood nearest-codeword decode: one (..., 30) @ (30, 16384)
    ±1 correlation against the full codebook, argmax, then the
    info bits are the bits of the winning index (no gather).  ok is the
    bounded-distance acceptance dist <= 3 = (d_min-1)/2 with d_min = 8:
    within it the winner is provably unique; at exactly 4 residual errors
    the true word is rejected (no other codeword can be nearer than 4).

    The reference truncates the systematic bits without checking OR
    correcting ("FIXME: RM3014-decode", tetra_lower_mac.c:231) and so
    consumes corrupted AACH unverified; this both gates and repairs it.
    Scores are exact at any matmul precision, TF32 and bf16 included:
    ±1 operands are exact in every input format and the integer sums
    (<= 30) accumulate exactly in f32, so the dot keeps the default
    precision.
    """
    x = 1.0 - 2.0 * bits30.astype(jnp.float32)
    scores = x @ jnp.asarray(_rm_codebook_pm1())        # (..., 16384)
    best = jnp.argmax(scores, axis=-1).astype(jnp.int32)
    dist = (30.0 - jnp.max(scores, axis=-1)) * 0.5
    info = ((best[..., None] >> jnp.arange(13, -1, -1)) & 1).astype(jnp.uint8)
    return info, dist <= 3.0


# ---------------------------------------------------------------------------
# Full control-block decode (type-5 -> type-1 + crc flag), batched per type
# ---------------------------------------------------------------------------


@jax.jit
def _decode_bbk_block(type5: jnp.ndarray, ks: jnp.ndarray):
    # one fused program for the BBK path: the eager descramble + slice +
    # GF(2) matmul otherwise costs ~10 separate dispatches per call, which
    # dominates single-channel host profiles
    return rm3014_decode(type5 ^ ks)


@partial(jax.jit, static_argnames=("blk_type",))
def _decode_cch_block(type5: jnp.ndarray, ks: jnp.ndarray, blk_type: int):
    name, t345, t2, t1, ia, has_crc = P.BLK_PARAMS[blk_type]
    type4 = type5 ^ ks
    type3 = deinterleave(type4, ia)
    soft = depuncture_soft(type3, P.PUNCT_2_3, t2 * 4, 4)
    type2 = viterbi_decode(soft, "cch")
    crc_ok = crc16_check(type2[..., : t1 + 16])
    return type2[..., :t1], crc_ok


# ---------------------------------------------------------------------------
# Mixed-type fused decode: ALL downlink block types in ONE device program
# ---------------------------------------------------------------------------

# variant table (geometry of P.BLK_PARAMS rows): (t345, t2, t1, ia)
_MIX_SB1, _MIX_NDB, _MIX_SCHF, _MIX_BBK = 0, 1, 2, 3
_MIX_VARIANTS = ((120, 80, 60, 11), (216, 144, 124, 101),
                 (432, 288, 268, 103))
_MIX_T345 = 432          # padded type-5 row length
_MIX_T2 = 288            # padded trellis steps
_MIX_T1 = 268            # padded type-1 row length
# Padding soft symbols appended after a shorter block's zero-terminated
# tail: the all-zero codeword (encoder input 0 from state 0 emits g=0 ->
# soft +1 per bit) at amplitude >> any reachable path-metric spread.  Every
# (state, input) != (0, 0) transition emits >= 1 nonzero coded bit (K=5
# means some generator carries the x^4 tap, and the mother code is
# non-catastrophic), so each padded step costs any non-zero-state path
# >= 2*amp while the 0->0 path gains the maximum 4*amp: traceback from
# state 0 at the padded end provably passes through state 0 at the true
# end, where metrics are spread at most 4*t2 < 2*amp.  The decoded prefix
# is therefore EXACTLY the per-type zero-terminated decode.
_MIX_PAD_AMP = 1000.0


@jax.jit
def _decode_mixed_jit(type5p: jnp.ndarray, ks: jnp.ndarray,
                      tsel: jnp.ndarray):
    """type5p/ks: (B, 432) uint8 (rows zero-padded past their type's
    length); tsel: (B,) int32 variant id (0 SB1 / 1 SB2-NDB / 2 SCH-F /
    3 BBK).  Returns (type1 (B, 268) uint8, ok (B,) bool).  Body shared
    with the packed-transfer variant (_decode_mixed_core below)."""
    type1pad, ok = _decode_mixed_core(type5p, ks, tsel)
    return type1pad[:, :_MIX_T1], ok


_MIX_VARIANT_OF = {}  # blk_type -> (variant id, t345, t1)


def _mix_variant(blk_type: int):
    if not _MIX_VARIANT_OF:
        _MIX_VARIANT_OF[P.TPSAP_T_SB1] = (_MIX_SB1, 120, 60)
        _MIX_VARIANT_OF[P.TPSAP_T_SB2] = (_MIX_NDB, 216, 124)
        _MIX_VARIANT_OF[P.TPSAP_T_NDB] = (_MIX_NDB, 216, 124)
        _MIX_VARIANT_OF[P.TPSAP_T_SCH_F] = (_MIX_SCHF, 432, 268)
        _MIX_VARIANT_OF[P.TPSAP_T_BBK] = (_MIX_BBK, 30, 14)
    return _MIX_VARIANT_OF.get(blk_type)


def decode_blocks_mixed(blocks: list[tuple[int, np.ndarray, int]]
                        ) -> list[tuple[np.ndarray, bool]]:
    """Decode a heterogeneous batch of type-5 blocks in ONE device call.

    blocks: [(blk_type, type5_bits, scramb_init)] -- every downlink block
    type (SB1/SB2/NDB/SCH-F/BBK; SB1 rows use the fixed SCRAMB_INIT per
    tetra_lower_mac.c:186-190 regardless of the passed init).  Returns
    [(type1_bits, crc_ok)] in order, each sliced to its type's length.

    Motivation: the per-type batching of decode_block costs up to 5
    dispatches per feed cycle; one fused program makes the FEC cost per
    cycle a single dispatch.  Results are
    bit-exact vs decode_block (see _MIX_PAD_AMP note + tests/test_fec.py).
    """
    B = len(blocks)
    bucket = 1 << max(2, (B - 1).bit_length())
    t5 = np.zeros((bucket, _MIX_T345), np.uint8)
    ksm = np.zeros((bucket, _MIX_T345), np.uint8)
    tsel = np.full((bucket,), _MIX_BBK, np.int32)
    metas = []
    for j, (blk_type, bits, scramb) in enumerate(blocks):
        mv = _mix_variant(blk_type)
        if mv is None:
            # type outside the fused program's variant table (SCH/HU: uplink
            # only, never emitted by the downlink burst splitter) -- decode
            # the whole batch on the per-type path rather than crash
            out = []
            for bt, bb, sc in blocks:
                t1b, okb = decode_block(jnp.asarray(np.asarray(bb)[None]),
                                        bt, sc)
                out.append((np.asarray(t1b)[0], bool(np.asarray(okb)[0])))
            return out
        var, t345, t1 = mv
        if blk_type == P.TPSAP_T_SB1:
            scramb = P.SCRAMB_INIT
        t5[j, :t345] = bits
        ksm[j, :t345] = keystream(int(scramb), t345)
        tsel[j] = var
        metas.append(t1)
    type1, ok = _decode_mixed_jit(jnp.asarray(t5), jnp.asarray(ksm),
                                  jnp.asarray(tsel))
    type1 = np.asarray(type1)
    ok = np.asarray(ok)
    return [(type1[j, :metas[j]], bool(ok[j])) for j in range(B)]


_MIX_TSEL_OF = np.full(8, -1, np.int32)
_MIX_TSEL_OF[P.TPSAP_T_SB1] = _MIX_SB1
_MIX_TSEL_OF[P.TPSAP_T_SB2] = _MIX_NDB
_MIX_TSEL_OF[P.TPSAP_T_NDB] = _MIX_NDB
_MIX_TSEL_OF[P.TPSAP_T_SCH_F] = _MIX_SCHF
_MIX_TSEL_OF[P.TPSAP_T_BBK] = _MIX_BBK

_KS432: dict[int, np.ndarray] = {}


def _ks432(scramb: int) -> np.ndarray:
    ks = _KS432.get(scramb)
    if ks is None:
        ks = _KS432[scramb] = fec_enc.scramb_keystream(scramb, _MIX_T345)
        if len(_KS432) > 4096:
            _KS432.clear()
    return ks


def decode_rows_mixed(t5: np.ndarray, blk_types: np.ndarray,
                      scrambs: np.ndarray, min_bucket: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Array-form decode_blocks_mixed: zero Python work per row.

    t5: (N, 432) uint8 type-5 rows zero-padded past each type's length
    (the layout rx.fleet's native engine emits); blk_types/scrambs: (N,).
    Returns (type1 (N, 268) uint8 rows, ok (N,) bool).  One device call.

    Keystream rows are full 432 bits regardless of the row's true type-5
    length: _decode_mixed_jit computes every variant for every row and
    selects by tsel, and each variant only reads its own [:t345] window,
    so descrambled garbage beyond a row's real bits never reaches its
    selected output (bit-exact vs decode_blocks_mixed; tests/test_fleet.py).
    """
    N = len(blk_types)
    tsel = _MIX_TSEL_OF[np.asarray(blk_types, np.int64)]
    assert (tsel >= 0).all(), "row type outside the fused variant table"
    scrambs = np.where(np.asarray(blk_types) == P.TPSAP_T_SB1,
                       P.SCRAMB_INIT, np.asarray(scrambs))
    ksm = np.empty((N, _MIX_T345), np.uint8)
    for s in np.unique(scrambs):
        ksm[scrambs == s] = _ks432(int(s))
    # min_bucket pins the padded batch to one shape so a steady-state
    # receiver compiles exactly ONE device program
    bucket = max(1 << max(2, (N - 1).bit_length()), min_bucket)
    if bucket != N:
        pad = bucket - N
        t5 = np.concatenate([t5, np.zeros((pad, _MIX_T345), np.uint8)])
        ksm = np.concatenate([ksm, np.zeros((pad, _MIX_T345), np.uint8)])
        tsel = np.concatenate([tsel, np.full(pad, _MIX_BBK, np.int32)])
    type1, ok = _decode_mixed_jit(jnp.asarray(t5), jnp.asarray(ksm),
                                  jnp.asarray(tsel))
    # writable host copies: callers patch rows in place (scramb adoption)
    return np.array(type1[:N]), np.array(ok[:N])


_T5_BYTES = _MIX_T345 // 8     # 54
_T1_BYTES = 34                 # ceil(268 / 8)
_KS_SLOTS = 16                 # device keystream table rows (distinct cells)


@jax.jit
def _decode_mixed_packed_jit(t5p: jnp.ndarray, ks_table: jnp.ndarray,
                             scramb_idx: jnp.ndarray, tsel: jnp.ndarray):
    """Transfer-lean variant of _decode_mixed_jit: type-5 rows arrive BIT-
    PACKED ((B, 54) uint8, MSB-first) and the keystream arrives as a row
    INDEX into a (16, 432) device-resident table (one-hot matmul, see
    _ks_from_table).  Returns (packed type1 (B, 34) uint8, ok (B,) bool).
    Packing cuts the per-cycle host<->device bytes of the FEC step (~7 MB
    of unpacked rows at 256 channels) ~14x each way."""
    type5 = _unpack_rows(t5p, _MIX_T345)
    ks = _ks_from_table(ks_table, scramb_idx)
    type1, ok = _decode_mixed_core(type5, ks, tsel)
    return _pack_t1(type1, ok)


def _decode_cch_core(type4, tsel):
    """Convolutional-coded (SB1/NDB/SCH-F) half of the mixed decode:
    depuncture every variant, select by tsel, ONE batched Viterbi + CRC.
    Returns ((B, 268) uint8 type-1 rows, (B,) ok)."""
    B = type4.shape[0]
    softs = []
    for t345, t2, t1, ia in _MIX_VARIANTS:
        t3 = type4[:, :t345][:, jnp.asarray(_deinterleave_idx(t345, ia))]
        soft = depuncture_soft(t3, P.PUNCT_2_3, t2 * 4, 4)
        if t2 < _MIX_T2:
            pad = jnp.full((B, _MIX_T2 - t2, 4), _MIX_PAD_AMP, jnp.float32)
            soft = jnp.concatenate([soft, pad], axis=1)
        softs.append(soft)
    t3d = tsel[:, None, None]
    soft = jnp.where(t3d == _MIX_SB1, softs[0],
                     jnp.where(t3d == _MIX_NDB, softs[1], softs[2]))
    type2 = viterbi_decode(soft, "cch")
    oks = [crc16_check(type2[..., : t1 + 16])
           for _, _, t1, _ in _MIX_VARIANTS]
    ok = jnp.where(tsel == _MIX_SB1, oks[0],
                   jnp.where(tsel == _MIX_NDB, oks[1], oks[2]))
    return type2[:, :_MIX_T1].astype(jnp.uint8), ok


def _decode_mixed_core(type4_in, ks, tsel):
    """Shared body of the mixed decode (see _decode_mixed_jit)."""
    B = type4_in.shape[0]
    type4 = type4_in ^ ks
    type1, ok = _decode_cch_core(type4, tsel)
    info14, ok_bbk = rm3014_decode(type4[:, :30])
    bbk_row = jnp.concatenate(
        [info14, jnp.zeros((B, _MIX_T1 - 14), info14.dtype)], axis=1)
    is_bbk = tsel == _MIX_BBK
    type1 = jnp.where(is_bbk[:, None], bbk_row.astype(jnp.uint8), type1)
    ok = jnp.where(is_bbk, ok_bbk, ok)
    # pad type1 to a byte multiple for the packers
    return jnp.concatenate(
        [type1, jnp.zeros((B, _T1_BYTES * 8 - _MIX_T1), jnp.uint8)],
        axis=1), ok


def _unpack_rows(t5p: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """(B, nbits//8) uint8 MSB-first packed rows -> (B, nbits) uint8 bits."""
    B = t5p.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    return ((t5p[:, :, None] >> shifts[None, None, :]) & 1).reshape(B, nbits)


def _ks_from_table(ks_table: jnp.ndarray, scramb_idx: jnp.ndarray
                   ) -> jnp.ndarray:
    """Row-index -> keystream via one-hot matmul.  Exact at any matmul
    precision, TF32 and bf16 included: 0/1 operands are exact in every
    input format and each output sums a single 0/1 product, so the dot
    keeps the default precision."""
    onehot = (scramb_idx[:, None] ==
              jnp.arange(_KS_SLOTS)[None, :]).astype(jnp.float32)
    return (onehot @ ks_table.astype(jnp.float32)).astype(jnp.uint8)


def _pack_t1(type1pad: jnp.ndarray, ok: jnp.ndarray) -> jnp.ndarray:
    """(B, 272) bits + (B,) ok -> ONE (B, 35) uint8 output array
    [packed type1 | ok] (every extra device->host fetch costs a fixed
    round trip)."""
    B = type1pad.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    t1b = type1pad.reshape(B, _T1_BYTES, 8)
    weights = (jnp.uint8(1) << shifts).astype(jnp.uint8)
    packed = jnp.sum(t1b * weights[None, None, :], axis=-1, dtype=jnp.uint8)
    return jnp.concatenate([packed, ok[:, None].astype(jnp.uint8)], axis=1)


@jax.jit
def _decode_cch_packed_jit(t5p: jnp.ndarray, ks_table: jnp.ndarray,
                           scramb_idx: jnp.ndarray, tsel: jnp.ndarray):
    """Split-program CCH decode (SB1/NDB/SCH-F rows only): the Viterbi is
    the mixed program's dominant cost and scales with the padded batch, so
    excluding the ~half of each cycle's rows that are BBK (and skipping the
    RM(30,14) correlation here) roughly halves it.  Same packed-transfer
    ABI as _decode_mixed_packed_jit."""
    type4 = _unpack_rows(t5p, _MIX_T345) ^ _ks_from_table(ks_table,
                                                          scramb_idx)
    type1, ok = _decode_cch_core(type4, tsel)
    pad = jnp.zeros((type1.shape[0], _T1_BYTES * 8 - _MIX_T1), jnp.uint8)
    return _pack_t1(jnp.concatenate([type1, pad], axis=1), ok)


@jax.jit
def _decode_bbk_packed_jit(t5p4: jnp.ndarray, ks_table: jnp.ndarray,
                           scramb_idx: jnp.ndarray):
    """Split-program BBK decode: RM(30,14) only, no trellis.  t5p4 is the
    first 4 packed bytes of each row (the 30 AACH bits); output ABI matches
    the other packed programs ((B, 35) = packed type1 | ok)."""
    bits32 = _unpack_rows(t5p4, 32)
    ks = _ks_from_table(ks_table[:, :30], scramb_idx)
    info14, ok = rm3014_decode(bits32[:, :30] ^ ks)
    B = info14.shape[0]
    pad = jnp.zeros((B, _T1_BYTES * 8 - 14), jnp.uint8)
    return _pack_t1(jnp.concatenate([info14, pad], axis=1), ok)


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def decode_rows_split_packed(t5p: np.ndarray, blk_types: np.ndarray,
                             scramb_idx: np.ndarray, ks_table: jnp.ndarray,
                             cch_bucket: int = 0, bbk_bucket: int = 0
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Packed-transfer decode via the SPLIT per-kind programs: CCH rows
    (Viterbi+CRC) and BBK rows (RM3014) each go to a fixed-size bucketed
    program; batches larger than a bucket are CHUNKED over repeated calls
    of the same compiled program instead of growing the shape (overflow --
    e.g. a post-acquisition ring-backlog drain -- must never recompile).
    Buckets can therefore be sized at the steady-state row rate rather
    than the worst case.  Returns (packed type1 (N, 34) uint8, ok (N,) bool) in
    input row order; results are bit-exact vs decode_rows_mixed_packed
    (tests/test_fleet.py)."""
    N = len(blk_types)
    tsel = _MIX_TSEL_OF[np.asarray(blk_types, np.int64)]
    assert (tsel >= 0).all(), "row type outside the fused variant table"
    idx = np.where(np.asarray(blk_types) == P.TPSAP_T_SB1, 0,
                   np.asarray(scramb_idx)).astype(np.int32)
    out = np.empty((N, _T1_BYTES + 1), np.uint8)
    is_bbk = tsel == _MIX_BBK
    ci = np.nonzero(~is_bbk)[0]
    bi = np.nonzero(is_bbk)[0]
    if len(ci):
        bucket = cch_bucket or _round_up(len(ci), 256)
        for s in range(0, len(ci), bucket):
            rows = ci[s:s + bucket]
            pad = bucket - len(rows)
            tc = np.concatenate([t5p[rows],
                                 np.zeros((pad, _T5_BYTES), np.uint8)])
            ic = np.concatenate([idx[rows], np.zeros(pad, np.int32)])
            sc = np.concatenate([tsel[rows],
                                 np.full(pad, _MIX_SB1, np.int32)])
            r = np.asarray(_decode_cch_packed_jit(
                jnp.asarray(tc), ks_table, jnp.asarray(ic),
                jnp.asarray(sc)))
            out[rows] = r[:len(rows)]
    if len(bi):
        bucket = bbk_bucket or _round_up(len(bi), 256)
        for s in range(0, len(bi), bucket):
            rows = bi[s:s + bucket]
            pad = bucket - len(rows)
            tb = np.concatenate([
                np.ascontiguousarray(t5p[rows, :4]),
                np.zeros((pad, 4), np.uint8)])
            ib = np.concatenate([idx[rows], np.zeros(pad, np.int32)])
            r = np.asarray(_decode_bbk_packed_jit(
                jnp.asarray(tb), ks_table, jnp.asarray(ib)))
            out[rows] = r[:len(rows)]
    return out[:, :_T1_BYTES], out[:, _T1_BYTES].astype(bool)


# ---------------------------------------------------------------------------
# Type-split packed decode (round 4): the wideband fleet's device batches
# are ~all SB1/NDB rows (BBK decodes natively at feed time; SCH-F exists
# only on traffic slots), yet the mixed program charged every row the
# SCH-F-sized costs: a 288-step trellis, a 54-byte upload and a 35-byte
# result row where SB1/NDB need 144 steps, 27 and 17 bytes
# (tetra_lower_mac.c:58-105 type-1 lengths: 60/124 vs 268).  Splitting by
# type halves the dominant FEC fetch AND the trellis work on
# signalling-heavy traffic, and the SCH-F program isn't even compiled
# until a traffic row appears.
# ---------------------------------------------------------------------------

_SHORT_T345 = 216              # max type-5 bits over SB1/SB2/NDB
_SHORT_T5_BYTES = 27
_SHORT_T2 = 144                # NDB trellis length (SB1 pads 80 -> 144)
_SHORT_T1 = 124
_SHORT_T1_BYTES = 16           # 124 bits + 4 pad
_SHORT_VARIANTS = _MIX_VARIANTS[:2]    # (120, 80, 60, 11), (216, 144, 124, 101)


@jax.jit
def _decode_short_packed_jit(t5p: jnp.ndarray, ks_table: jnp.ndarray,
                             scramb_idx: jnp.ndarray, tsel: jnp.ndarray):
    """SB1/SB2/NDB-only packed decode: t5p (B, 27) bit-packed rows, tsel
    (B,) in {_MIX_SB1, _MIX_NDB}.  Returns ONE (B, 17) uint8 array:
    [16 bytes = type-1 bits 0..123 packed MSB-first (4 pad bits) | ok].
    Bit-exact vs the mixed program's leading 124 type-1 bits (same
    depuncture/trellis/CRC math; the _MIX_PAD_AMP argument covers the
    SB1 80 -> 144 step padding exactly as it covered 80 -> 288)."""
    B = t5p.shape[0]
    type4 = _unpack_rows(t5p, _SHORT_T345) \
        ^ _ks_from_table(ks_table, scramb_idx)[:, :_SHORT_T345]
    softs = []
    for t345, t2, t1, ia in _SHORT_VARIANTS:
        t3 = type4[:, :t345][:, jnp.asarray(_deinterleave_idx(t345, ia))]
        soft = depuncture_soft(t3, P.PUNCT_2_3, t2 * 4, 4)
        if t2 < _SHORT_T2:
            pad = jnp.full((B, _SHORT_T2 - t2, 4), _MIX_PAD_AMP,
                           jnp.float32)
            soft = jnp.concatenate([soft, pad], axis=1)
        softs.append(soft)
    soft = jnp.where(tsel[:, None, None] == _MIX_SB1, softs[0], softs[1])
    type2 = viterbi_decode(soft, "cch")
    ok = jnp.where(tsel == _MIX_SB1,
                   crc16_check(type2[..., : 60 + 16]),
                   crc16_check(type2[..., : 124 + 16]))
    # pack the first 128 (not 124) decoded bits: bits 124..127 are the
    # leading CRC bits of an NDB row, so the 16-byte head stays BYTE-EXACT
    # with the mixed program's rows (consumers only read t1 bits; tests
    # compare heads exactly)
    t1b = type2[:, :_SHORT_T1_BYTES * 8].astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    weights = (jnp.uint8(1) << shifts).astype(jnp.uint8)
    packed = jnp.sum(t1b.reshape(B, _SHORT_T1_BYTES, 8) *
                     weights[None, None, :], axis=-1, dtype=jnp.uint8)
    return jnp.concatenate([packed, ok[:, None].astype(jnp.uint8)], axis=1)


@jax.jit
def _decode_schf_packed_jit(t5p: jnp.ndarray, ks_table: jnp.ndarray,
                            scramb_idx: jnp.ndarray):
    """SCH-F-only packed decode (full 432-bit rows, 288-step trellis);
    output ABI matches the mixed program ((B, 35) = packed 268-bit type1 |
    ok).  Compiled lazily: a signalling-only receiver never pays it."""
    B = t5p.shape[0]
    type4 = _unpack_rows(t5p, _MIX_T345) ^ _ks_from_table(ks_table,
                                                          scramb_idx)
    t345, t2, t1, ia = _MIX_VARIANTS[2]
    t3 = type4[:, jnp.asarray(_deinterleave_idx(t345, ia))]
    soft = depuncture_soft(t3, P.PUNCT_2_3, t2 * 4, 4)
    type2 = viterbi_decode(soft, "cch")
    ok = crc16_check(type2[..., : t1 + 16])
    pad = jnp.zeros((B, _T1_BYTES * 8 - _MIX_T1), jnp.uint8)
    return _pack_t1(jnp.concatenate(
        [type2[:, :_MIX_T1].astype(jnp.uint8), pad], axis=1), ok)


def decode_rows_typed_packed(t5p: np.ndarray, blk_types: np.ndarray,
                             scramb_idx: np.ndarray, ks_table: jnp.ndarray,
                             short_bucket: int = 0, schf_bucket: int = 0,
                             bbk_bucket: int = 0
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Packed-transfer decode via the per-length programs above: SB1/NDB
    rows upload 27 bytes and fetch 17, SCH-F rows keep the 54/35-byte
    forms, BBK rows (rare here: the fleet engine decodes them natively at
    feed time) go to the existing RM3014 program.  Oversize batches CHUNK
    over the same compiled programs (fixed shapes, no recompiles).
    Returns (packed type1 (N, 34) uint8, ok (N,) bool) in input
    row order, bit-exact vs decode_rows_mixed_packed (tests/test_fleet.py).
    """
    N = len(blk_types)
    tsel = _MIX_TSEL_OF[np.asarray(blk_types, np.int64)]
    assert (tsel >= 0).all(), "row type outside the fused variant table"
    idx = np.where(np.asarray(blk_types) == P.TPSAP_T_SB1, 0,
                   np.asarray(scramb_idx)).astype(np.int32)
    out = np.zeros((N, _T1_BYTES + 1), np.uint8)
    si = np.nonzero((tsel == _MIX_SB1) | (tsel == _MIX_NDB))[0]
    fi = np.nonzero(tsel == _MIX_SCHF)[0]
    bi = np.nonzero(tsel == _MIX_BBK)[0]
    if len(si):
        bucket = short_bucket or _round_up(len(si), 256)
        # dispatch EVERY chunk before fetching any: device dispatch is
        # async, so chunk j+1's input upload + trellis compute overlap
        # chunk j's result fetch
        pend = []
        for s in range(0, len(si), bucket):
            rows = si[s:s + bucket]
            pad = bucket - len(rows)
            tc = np.concatenate([np.ascontiguousarray(
                t5p[rows, :_SHORT_T5_BYTES]),
                np.zeros((pad, _SHORT_T5_BYTES), np.uint8)])
            ic = np.concatenate([idx[rows], np.zeros(pad, np.int32)])
            sc = np.concatenate([tsel[rows],
                                 np.full(pad, _MIX_SB1, np.int32)])
            pend.append((rows, _decode_short_packed_jit(
                jnp.asarray(tc), ks_table, jnp.asarray(ic),
                jnp.asarray(sc))))
        for rows, dev in pend:
            r = np.asarray(dev)
            out[rows, :_SHORT_T1_BYTES] = r[:len(rows), :_SHORT_T1_BYTES]
            out[rows, _T1_BYTES] = r[:len(rows), _SHORT_T1_BYTES]
    if len(fi):
        bucket = schf_bucket or _round_up(len(fi), 256)
        for s in range(0, len(fi), bucket):
            rows = fi[s:s + bucket]
            pad = bucket - len(rows)
            tc = np.concatenate([t5p[rows],
                                 np.zeros((pad, _T5_BYTES), np.uint8)])
            ic = np.concatenate([idx[rows], np.zeros(pad, np.int32)])
            r = np.asarray(_decode_schf_packed_jit(
                jnp.asarray(tc), ks_table, jnp.asarray(ic)))
            out[rows] = r[:len(rows)]
    if len(bi):
        bucket = bbk_bucket or _round_up(len(bi), 256)
        for s in range(0, len(bi), bucket):
            rows = bi[s:s + bucket]
            pad = bucket - len(rows)
            tb = np.concatenate([
                np.ascontiguousarray(t5p[rows, :4]),
                np.zeros((pad, 4), np.uint8)])
            ib = np.concatenate([idx[rows], np.zeros(pad, np.int32)])
            r = np.asarray(_decode_bbk_packed_jit(
                jnp.asarray(tb), ks_table, jnp.asarray(ib)))
            out[rows] = r[:len(rows)]
    return out[:, :_T1_BYTES], out[:, _T1_BYTES].astype(bool)


def decode_rows_mixed_packed(t5p: np.ndarray, blk_types: np.ndarray,
                             scramb_idx: np.ndarray, ks_table: jnp.ndarray,
                             min_bucket: int = 0
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Packed-transfer decode: t5p (N, 54) bit-packed rows, scramb_idx (N,)
    rows into the (16, 432) device-resident ks_table (slot 0 must hold the
    SCRAMB_INIT keystream; SB1 rows are forced to it here).  Returns
    (packed type1 (N, 34) uint8, ok (N,) bool).

    min_bucket > 0 pins the device batch to that ONE shape: short batches
    pad up to it and oversize batches CHUNK over repeated calls of the same
    compiled program (overflow -- e.g. a post-acquisition ring-backlog
    drain -- must never grow the shape).  The bucket can therefore sit at
    the steady-state row rate instead of the worst case.  With
    min_bucket == 0 the batch pads to the next power of two (ad-hoc
    callers)."""
    N = len(blk_types)
    tsel = _MIX_TSEL_OF[np.asarray(blk_types, np.int64)]
    assert (tsel >= 0).all(), "row type outside the fused variant table"
    idx = np.where(np.asarray(blk_types) == P.TPSAP_T_SB1, 0,
                   np.asarray(scramb_idx)).astype(np.int32)
    bucket = min_bucket or (1 << max(2, (N - 1).bit_length()))
    out = np.empty((N, _T1_BYTES + 1), np.uint8)
    for s in range(0, N, bucket):
        n = min(bucket, N - s)
        pad = bucket - n
        tc = t5p[s:s + n]
        ic, sc = idx[s:s + n], tsel[s:s + n]
        if pad:
            tc = np.concatenate([tc, np.zeros((pad, _T5_BYTES), np.uint8)])
            ic = np.concatenate([ic, np.zeros(pad, np.int32)])
            sc = np.concatenate([sc, np.full(pad, _MIX_BBK, np.int32)])
        out[s:s + n] = np.asarray(_decode_mixed_packed_jit(
            jnp.asarray(tc), ks_table, jnp.asarray(ic),
            jnp.asarray(sc)))[:n]
    return (np.ascontiguousarray(out[:, :_T1_BYTES]),
            out[:, _T1_BYTES].astype(bool))


def decode_block(type5: jnp.ndarray, blk_type: int,
                 scramb_init) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode a batch of type-5 blocks of one type.

    type5: (B, type345_bits) uint8.  Returns (type1 bits (B, t1), ok (B,)).
    SB1 blocks always use the predefined scrambling code (tetra_lower_mac.c:
    186-190); BBK blocks use the RM(30,14) path.

    scramb_init: a single LFSR init shared by the whole batch, or a
    length-B sequence of per-row inits (cross-channel batches, where each
    row may belong to a different cell).

    Batches are padded to power-of-two buckets so repeated calls with varying
    burst counts reuse compiled programs.
    """
    if blk_type == P.TPSAP_T_SB1:
        scramb_init = P.SCRAMB_INIT
    name, t345, t2, t1, ia, has_crc = P.BLK_PARAMS[blk_type]
    B = type5.shape[0]
    bucket = 1 << max(2, (B - 1).bit_length())
    if np.ndim(scramb_init) == 0:
        ks = jnp.asarray(keystream(int(scramb_init), t345))
    else:
        assert len(scramb_init) == B
        ks_rows = np.stack([keystream(int(s), t345) for s in scramb_init])
        if bucket != B:
            ks_rows = np.concatenate(
                [ks_rows, np.zeros((bucket - B, t345), ks_rows.dtype)])
        ks = jnp.asarray(ks_rows)
    if bucket != B:
        pad = jnp.zeros((bucket - B, type5.shape[1]), type5.dtype)
        type5 = jnp.concatenate([type5, pad], axis=0)
    if blk_type == P.TPSAP_T_BBK:
        out, ok = _decode_bbk_block(type5, ks)
    else:
        out, ok = _decode_cch_block(type5, ks, blk_type)
    return out[:B], ok[:B]
