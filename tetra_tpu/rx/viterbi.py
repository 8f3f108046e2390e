"""Batched soft-decision Viterbi decoder for the TETRA K=5 mother codes (JAX).

Batched re-design of the reference's generic trellis decoder
(lower_mac/osmo_conv.c, viterbi_cch.c, viterbi_tch.c): instead of a scalar
ACS loop per block, the 16-state trellis is laid out on the vector unit and
the decoder is batched over an arbitrary leading block axis, with
`lax.scan` carrying the path metrics through trellis time.  Throughput comes
from the batch (bursts x channels), exactly as SURVEY.md section 7 plans.

Soft-bit convention (matches viterbi.c:6-25): +1 ~ transmitted bit 0,
-1 ~ transmitted bit 1, 0 ~ punctured/unknown.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P

N_STATES = 16  # K=5 -> 2^(K-1)


def _trellis_tables(polys: np.ndarray):
    """Expected-sign table E[s, b, n] = 1-2*g_n and predecessor tables.

    State bit i holds the input bit delayed by i+1 (bit0 = most recent);
    transition s --b--> ((s<<1)|b) & 15.
    """
    n_out = polys.shape[0]
    E = np.empty((N_STATES, 2, n_out), np.float32)
    for s in range(N_STATES):
        delayed = [(s >> i) & 1 for i in range(4)]
        for b in range(2):
            window = np.array([b] + delayed, np.int64)  # [x_n, x_{n-1}..x_{n-4}]
            g = (polys.astype(np.int64) @ window) % 2
            E[s, b] = 1.0 - 2.0 * g
    # predecessors of state ns: prev in {ns>>1, (ns>>1)+8}, input bit = ns & 1
    ns = np.arange(N_STATES)
    prev0 = ns >> 1
    prev1 = (ns >> 1) + 8
    b_of = ns & 1
    # NUMPY results: module-level jnp arrays captured inside a shard_map
    # trace become tracers (per-device broadcast lifting), which crashed
    # _acs_tables' host-side reindexing on a cold cache; keep the tables
    # host-side and convert at the jit boundary instead
    return (E, prev0.astype(np.int32), prev1.astype(np.int32),
            b_of.astype(np.int32))


_CCH_TABLES = _trellis_tables(P.CONV_CCH_POLYS)
_TCH_TABLES = _trellis_tables(P.CONV_TCH_POLYS)

# plain python float: a module-level jnp scalar (and scatter-built
# init constants) can leak mesh-stamped avals between shard_map
# contexts through the jax literal pool (seen in dryrun_multichip:
# 2-D superblock trace then 1-D fec trace in one process)
_NEG = -1e9

# lax.scan unroll factor for the ACS/traceback loops (read at trace time).
# The mixed-FEC program's per-call latency is dominated by the 288
# sequential trellis steps; unrolling lets XLA fuse/pipeline consecutive
# steps.  Override with TETRA_VIT_UNROLL.
import os as _os

SCAN_UNROLL = int(_os.environ.get("TETRA_VIT_UNROLL", "4"))


@lru_cache(maxsize=4)
def _acs_tables(use_tch: bool):
    """Gather-free ACS operand tables.

    The reference-shaped formulation indexed bm[:, prev, b_of] and
    metrics[:, prev] with fancy indices -- a gather per trellis step.
    Because prev0[ns] = ns>>1 enumerates [0,0,1,1,..,7,7] (and
    prev1 the same + 8), metrics[:, prev] is exactly a repeat() of each
    half (a free broadcast/reshape), and the branch-metric selection
    collapses into two precomputed (16, n) expected-sign tables
    E0[ns] = E[prev0[ns], b_of[ns]], E1[ns] = E[prev1[ns], b_of[ns]]:
    cand_k = repeat(metrics_half_k) + y @ Ek^T, bit-identical to the
    fancy-index form (the dot runs at Precision.HIGHEST)."""
    E, prev0, prev1, b_of = (_TCH_TABLES if use_tch else _CCH_TABLES)
    E_n = np.asarray(E)
    p0, p1, bo = (np.asarray(prev0), np.asarray(prev1), np.asarray(b_of))
    E0 = E_n[p0, bo]        # (16, n)
    E1 = E_n[p1, bo]
    # numpy results: the cache must never hold arrays materialized inside a
    # jit trace (they would leak tracers into later traces)
    return np.ascontiguousarray(E0.T), np.ascontiguousarray(E1.T)


@partial(jax.jit, static_argnames=("n_out", "use_tch", "truncate"))
def _viterbi(soft: jnp.ndarray, n_out: int, use_tch: bool,
             truncate: bool) -> jnp.ndarray:
    E0t, E1t = (jnp.asarray(t) for t in _acs_tables(use_tch))
    B, T, _ = soft.shape
    bitw = (jnp.int32(1) << jnp.arange(N_STATES, dtype=jnp.int32))[None, :]

    def acs(metrics, y):
        # y: (B, n_out); cand_k[b, ns] = metrics[b, prev_k] + y @ Ek
        cand0 = jnp.repeat(metrics[:, :8], 2, axis=1) + jnp.dot(
            y, E0t, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        cand1 = jnp.repeat(metrics[:, 8:], 2, axis=1) + jnp.dot(
            y, E1t, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        take1 = cand1 > cand0
        new = jnp.where(take1, cand1, cand0)
        new = new - jnp.max(new, axis=1, keepdims=True)  # normalize
        # decisions bit-packed per row: 16 bool lanes -> one int32 word
        # (8x less HBM store/load traffic than a (B, 16) bool slab, and the
        # traceback reads it with a vector shift instead of a gather)
        mask = jnp.sum(jnp.where(take1, bitw, 0), axis=1, dtype=jnp.int32)
        return new, mask

    lane = jax.lax.broadcasted_iota(jnp.int32, (B, N_STATES), 1)
    init = jnp.where(lane == 0, 0.0, _NEG).astype(jnp.float32)
    final, decisions = jax.lax.scan(acs, init, jnp.swapaxes(soft, 0, 1),
                                    unroll=SCAN_UNROLL)
    # decisions: (T, B) int32 bitmask of take1 per state

    def trace(state, dec_t):
        # state: (B,) current state AFTER transition t; its LSB is bit_t
        bit = (state & 1).astype(jnp.uint8)
        took1 = ((dec_t >> state) & 1) == 1
        prev = jnp.where(took1, (state >> 1) + 8, state >> 1)
        return prev, bit

    if truncate:
        # unterminated block: best-metric end state (osmo_conv.c:588-599)
        start = jnp.argmax(final, axis=1).astype(jnp.int32)
    else:
        start = jnp.zeros((B,), jnp.int32)  # zero-terminated (4 tail bits)
    _, bits_rev = jax.lax.scan(trace, start, decisions, reverse=True,
                               unroll=SCAN_UNROLL)
    return jnp.swapaxes(bits_rev, 0, 1)  # (B, T) -- scan(reverse) keeps order


# ---------------------------------------------------------------------------
# Generic engine: arbitrary non-recursive (n, K <= 8) codes + tail-biting
# (capability parity with osmo_conv.c:484-774, which handles n = 2..4,
# K = 5/7, FLUSH / TRUNCATION / TAIL_BITING; this engine is not limited to
# those n/K pairs).  Same batched lax.scan layout as the specialized decoder
# above; throughput still comes from the batch axis.
# ---------------------------------------------------------------------------

from functools import lru_cache


@lru_cache(maxsize=32)
def _generic_tables(polys: tuple[tuple[int, ...], ...]):
    """Trellis tables for polys[(n, K)] with taps over [x_t, x_{t-1}, ...].

    Returns (E, prev0, prev1, b_of, S): E[s, b, n] = +-1 expected soft sign,
    predecessor tables for next-state ns = ((s << 1) | b) mod S (the
    convention of viterbi_cch.c:36-60 / gen_state_info in osmo_conv.c).
    """
    pm = np.asarray(polys, np.int64)
    n_out, K = pm.shape
    S = 1 << (K - 1)
    E = np.empty((S, 2, n_out), np.float32)
    for s in range(S):
        delayed = [(s >> i) & 1 for i in range(K - 1)]
        for b in range(2):
            window = np.array([b] + delayed, np.int64)
            E[s, b] = 1.0 - 2.0 * ((pm @ window) % 2)
    ns = np.arange(S)
    # numpy results: the cache must never hold arrays materialized inside a
    # jit trace (they would leak tracers into later traces)
    return (E, (ns >> 1).astype(np.int32),
            ((ns >> 1) + S // 2).astype(np.int32),
            (ns & 1).astype(np.int32), S)


@partial(jax.jit, static_argnames=("polys", "term"))
def _viterbi_generic(soft: jnp.ndarray, polys: tuple, term: str):
    E_n, prev0_n, prev1_n, b_of_n, S = _generic_tables(polys)
    E, prev0, prev1, b_of = (jnp.asarray(E_n), jnp.asarray(prev0_n),
                             jnp.asarray(prev1_n), jnp.asarray(b_of_n))
    B, T, _ = soft.shape
    half = S // 2

    def acs(metrics, y):
        bm = jnp.einsum("bn,sen->bse", y, E,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
        cand0 = metrics[:, prev0] + bm[:, prev0, b_of]
        cand1 = metrics[:, prev1] + bm[:, prev1, b_of]
        take1 = cand1 > cand0
        new = jnp.where(take1, cand1, cand0)
        new = new - jnp.max(new, axis=1, keepdims=True)
        return new, take1

    seq = jnp.swapaxes(soft, 0, 1)                       # (T, B, n)
    if term == "tailbite":
        # osmo_conv tail-biting (conv_decode, osmo_conv.c:745-764): uniform
        # start metrics, TWO forward passes (wrap-around), decisions from
        # the second pass
        init = jnp.zeros((B, S), jnp.float32)
        mid, _ = jax.lax.scan(acs, init, seq)
        final, decisions = jax.lax.scan(acs, mid, seq)
    else:
        lane = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
        init = jnp.where(lane == 0, 0.0, _NEG).astype(jnp.float32)
        final, decisions = jax.lax.scan(acs, init, seq)

    def trace(state, dec_t):
        bit = (state & 1).astype(jnp.uint8)
        took1 = jnp.take_along_axis(dec_t, state, axis=1)
        prev = jnp.where(took1, (state >> 1) + half, state >> 1)
        return prev, bit

    if term == "zero":
        start = jnp.zeros((B, 1), jnp.int32)
    elif term == "truncate":
        start = jnp.argmax(final, axis=1).astype(jnp.int32)[:, None]
    else:
        # tail-biting state selection (traceback, osmo_conv.c:572-599):
        # among states whose len-step traceback returns to themselves
        # (circular consistency), pick the best end metric; if none is
        # consistent, fall back to the best end metric overall.  All S
        # candidate tracebacks run vectorized.
        all_states = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None],
                                      (B, S))
        back, _ = jax.lax.scan(trace, all_states, decisions, reverse=True)
        consistent = back == all_states
        score = jnp.where(consistent, final, final - jnp.float32(1e9))
        any_c = jnp.any(consistent, axis=1, keepdims=True)
        score = jnp.where(any_c, score, final)
        start = jnp.argmax(score, axis=1).astype(jnp.int32)[:, None]
    _, bits_rev = jax.lax.scan(trace, start, decisions, reverse=True)
    return jnp.swapaxes(bits_rev[..., 0], 0, 1)          # (B, T)


def viterbi_decode_generic(soft: jnp.ndarray, polys, term: str = "zero"
                           ) -> jnp.ndarray:
    """Decode any non-recursive convolutional code, batched.

    soft: (B, T, n) float32, +1 ~ bit 0 / -1 ~ bit 1 / 0 ~ punctured;
    polys: (n, K) generator tap matrix (rows g_i over [x_t .. x_{t-K+1}]),
    or a nested tuple of the same.  term: "zero" (encoder flushed to state
    0 -- tail steps included in soft), "truncate" (direct truncation:
    traceback from the best end state), or "tailbite" (tail-biting:
    wrap-around pass + circularly-consistent best state, the
    CONV_TERM_TAIL_BITING semantics of osmo_conv.c).

    The TETRA downlink itself only ever needs the two K=5 codes of
    viterbi_decode(); this engine provides the reference's full osmo_conv
    generality (and beyond: any K <= 8, any n) for uplink/auxiliary use.
    """
    if not isinstance(polys, tuple):
        polys = tuple(tuple(int(x) for x in row) for row in np.asarray(polys))
    assert soft.shape[-1] == len(polys)
    assert term in ("zero", "truncate", "tailbite")
    return _viterbi_generic(soft.astype(jnp.float32), polys, term)


def viterbi_decode(soft: jnp.ndarray, code: str = "cch",
                   term: str = "zero") -> jnp.ndarray:
    """Decode batched soft mother-code symbols.

    soft: (B, T, N) float32 in [-1, 1] (0 = punctured), N=4 for the data
    (CCH) code, N=3 for the speech (TCH) code.  Returns (B, T) uint8 decoded
    bits.  term="zero" assumes zero-terminated blocks (the in-band tail bits
    of clause 8.2.3 drive the encoder back to state 0, so traceback starts at
    state 0 - same result as the reference's FLUSH handling of
    osmo_conv.c:567-614); term="truncate" starts traceback from the
    best-metric end state (unterminated speech class-1 blocks).
    """
    use_tch = code == "tch"
    n_out = 3 if use_tch else 4
    assert soft.shape[-1] == n_out
    return _viterbi(soft.astype(jnp.float32), n_out, use_tch,
                    term == "truncate")
