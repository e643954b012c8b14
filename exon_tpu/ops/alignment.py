"""Smith-Waterman local alignment on the device.

Replaces the reference's vendored rust-bio pairwise aligner
(exon-core/src/rust_bio_alignment/pairwise/, used by the alignment_score
UDF with match=+1, mismatch=-1, gap open=-1, gap extend=-1).

With the aligner's linear-ish gap model (a gap of length L costs
open + L·extend = -(1+L)), both gap terms admit running-max recurrences:

  F_i[j] = max_k<j (H_i[k] − (1 + (j−k)))  = cummax_j(H_i[j] + j) − j − 1
  E_i[j] = max_{i'<i}(H_{i'}[j] − (1 + (i−i')))  → carried column max

so the whole DP is a lax.scan over the query (M steps), each step a
vectorized pass over [rows, L] — no per-cell scalar loops. Scores clamp at
0 (local alignment) and positions past each row's length are masked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import VarColumn
from .layout import row_lengths

NEG = jnp.int32(-(1 << 20))


def to_padded_matrix(col: VarColumn, max_len: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[rows, max_len] byte matrix + valid mask from a flat VarColumn."""
    starts = col.offsets[:-1]
    lens = row_lengths(col.offsets)
    pos = starts[:, None] + jnp.arange(max_len, dtype=jnp.int32)[None, :]
    valid = jnp.arange(max_len, dtype=jnp.int32)[None, :] < lens[:, None]
    vals = col.values[jnp.clip(pos, 0, col.value_capacity - 1)]
    return jnp.where(valid, vals, 0), valid


@functools.partial(jax.jit, static_argnums=(3,))
def sw_scores_vs_query(seq_mat: jnp.ndarray, seq_valid: jnp.ndarray,
                       query: jnp.ndarray, match_score: int = 1) -> jnp.ndarray:
    """Local alignment best score of each row against ``query`` (uint8[M])."""
    n, L = seq_mat.shape
    jpos = jnp.arange(L, dtype=jnp.int32)

    def step(carry, q_char):
        H_prev, colmax = carry
        # colmax[j] = max_{i'<=i-1} (H_{i'}[j] + i') - i  tracked incrementally:
        # we keep colmax as max(H + row offset); subtracting happens via decay
        s = jnp.where(seq_mat == q_char, match_score, -1).astype(jnp.int32)
        s = jnp.where(seq_valid, s, NEG)
        diag = jnp.concatenate(
            [jnp.zeros((n, 1), jnp.int32), H_prev[:, :-1]], axis=1) + s
        # gap in query direction: E_i[j] = max_{i'<i}(H_{i'}[j] − (1+(i−i')))
        # with colmax ≡ max_{i'≤i-1}(H_{i'}[j] − ((i−1)−i')) ⇒ E = colmax − 2
        E = colmax - 2
        # H without F first
        H0 = jnp.maximum(jnp.maximum(diag, E), 0)
        # F: gap along the sequence: cummax of (H[k] + k) - j - 1; H here
        # depends on F only through longer gaps which the cummax already
        # covers after one fixup pass
        run = jax.lax.cummax(H0 + jpos[None, :], axis=1)
        F = jnp.concatenate([jnp.full((n, 1), NEG),
                             run[:, :-1] - jpos[None, 1:] - 1], axis=1)
        H = jnp.maximum(H0, jnp.maximum(F, 0))
        H = jnp.where(seq_valid, H, 0)
        new_colmax = jnp.maximum(colmax - 1, H)
        best = jnp.max(H, axis=1)
        return (H, new_colmax), best

    init = (jnp.zeros((n, L), jnp.int32), jnp.full((n, L), NEG))
    (_, _), bests = jax.lax.scan(step, init, query.astype(jnp.uint8))
    return jnp.max(bests, axis=0).astype(jnp.int32)


def sw_scores_pairwise(seq_mat: jnp.ndarray, seq_valid: jnp.ndarray,
                       q_mat: jnp.ndarray, q_valid: jnp.ndarray,
                       match_score: int = 1) -> jnp.ndarray:
    """Row-wise local alignment: row i of ``seq_mat`` against row i of
    ``q_mat`` (alignment_score(s1_col, s2_col) form)."""
    n, L = seq_mat.shape
    jpos = jnp.arange(L, dtype=jnp.int32)

    def step(carry, q_col):
        q_char, q_ok = q_col
        H_prev, colmax = carry
        s = jnp.where(seq_mat == q_char[:, None], match_score, -1)
        s = jnp.where(seq_valid & q_ok[:, None], s, NEG).astype(jnp.int32)
        diag = jnp.concatenate(
            [jnp.zeros((n, 1), jnp.int32), H_prev[:, :-1]], axis=1) + s
        E = colmax - 2
        H0 = jnp.maximum(jnp.maximum(diag, E), 0)
        run = jax.lax.cummax(H0 + jpos[None, :], axis=1)
        F = jnp.concatenate([jnp.full((n, 1), NEG),
                             run[:, :-1] - jpos[None, 1:] - 1], axis=1)
        H = jnp.maximum(H0, jnp.maximum(F, 0))
        H = jnp.where(seq_valid & q_ok[:, None], H, 0)
        new_colmax = jnp.maximum(colmax - 1, H)
        best = jnp.max(H, axis=1)
        return (H, new_colmax), best

    init = (jnp.zeros((n, L), jnp.int32), jnp.full((n, L), NEG))
    (_, _), bests = jax.lax.scan(
        step, init, (q_mat.T.astype(jnp.uint8), q_valid.T))
    return jnp.max(bests, axis=0).astype(jnp.int32)


def alignment_scores_pairwise(a: VarColumn, b: VarColumn,
                              cap_len: int = 2048) -> jnp.ndarray:
    """alignment_score(s1_col, s2_col) → int32 per-row local SW scores."""
    la = np.asarray(jax.device_get(row_lengths(a.offsets)))
    lb = np.asarray(jax.device_get(row_lengths(b.offsets)))
    La = max(128, ((int(min(cap_len, max(la.max() if la.size else 1, 1)))
                    + 127) // 128) * 128)
    Lb = max(128, ((int(min(cap_len, max(lb.max() if lb.size else 1, 1)))
                    + 127) // 128) * 128)
    a_mat, a_valid = to_padded_matrix(a, La)
    b_mat, b_valid = to_padded_matrix(b, Lb)
    return sw_scores_pairwise(a_mat, a_valid, b_mat, b_valid)


def alignment_scores(col: VarColumn, query: bytes, cap_len: int = 2048
                     ) -> jnp.ndarray:
    """alignment_score(seq_col, 'QUERY') → int32 scores per row."""
    lens_host = np.asarray(jax.device_get(row_lengths(col.offsets)))
    max_len = int(lens_host.max()) if lens_host.size else 1
    L = int(min(cap_len, max(max_len, 1)))
    # round L to a lane multiple for clean tiling
    L = max(128, ((L + 127) // 128) * 128)
    mat, valid = to_padded_matrix(col, L)
    q = jnp.asarray(np.frombuffer(query, dtype=np.uint8))
    return sw_scores_vs_query(mat, valid, q)
