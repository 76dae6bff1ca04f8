"""The V(D)J forward pass as a JAX kernel.

The state space is a chain of regions; the junction recursions are the hot
loop: one row-vector x matrix product per junction site, which batches over
the posterior tree ensemble into [T, S] x [S, S] matmuls.

Numerics: transitions stay in linear space (they are plain probabilities);
emissions arrive in log space; the carried forward vector is kept
max-normalized with an explicit per-tree log-scale accumulator.  This is
the accelerator-native replacement for the reference's SCALE_FACTOR=2^256
block-scaling trick (reference: src/HMM.cpp:254-354, src/utils.cpp:135-144).

All functions take a leading batch ("tree") axis T on emissions and return
batched log-likelihoods; pass T=1 for the star-tree model.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class ForwardCache(NamedTuple):
    """Max-normalized forward vectors kept for backward sampling.

    Normalization cancels inside every categorical the sampler draws, so the
    log-scales are not needed here.
    """

    vgerm_u: jnp.ndarray           # [T, Gv]
    vd_u: jnp.ndarray              # [R1, T, S1]
    dgerm_u: Optional[jnp.ndarray]  # [T, Gd] (igh only)
    dj_u: Optional[jnp.ndarray]     # [R2, T, S2] (igh only)
    jgerm_u: jnp.ndarray           # [T, Gj]


def _mm(a, b):
    # Full f32 products: on the GPU a default-precision f32 matmul may run
    # in TF32 (~10 mantissa bits), which the log-likelihood cannot absorb.
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _normalize(f_log: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split log-space values into (max-normalized linear, log-scale)."""
    m = jnp.max(f_log, axis=-1)
    u = jnp.exp(f_log - m[..., None])
    return u, m


def _junction_scan(
    germ_u: jnp.ndarray,          # [T, G]  normalized entry vector
    germ_scale: jnp.ndarray,      # [T]
    germ_junction: jnp.ndarray,   # [G, S]
    junction: jnp.ndarray,        # [S, S]
    emis_log: jnp.ndarray,        # [T, R, S]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the junction recursion; returns (rows_u [R,T,S], u_last, scale)."""
    if emis_log.shape[1] == 0:
        # Zero-width junction windows are rejected with an actionable
        # message at state-space build time (compiler/state_space.py);
        # this guard keeps the trace error readable if one sneaks through.
        raise ValueError(
            "junction emission has zero site rows; the flexbounds collapse "
            "this junction window to nothing")
    f0_log = jnp.log(_mm(germ_u, germ_junction)) + emis_log[:, 0]
    u0, m0 = _normalize(f0_log)

    def step(carry, e_row):
        u, scale = carry
        f_log = jnp.log(_mm(u, junction)) + e_row
        u_next, m = _normalize(f_log)
        return (u_next, scale + m), u_next

    (u_last, scale), rows = jax.lax.scan(
        step, (u0, germ_scale + m0),
        jnp.moveaxis(emis_log[:, 1:], 0, 1),  # [R-1, T, S]
    )
    rows = jnp.concatenate([u0[None], rows], axis=0)
    return rows, u_last, scale


def _germline_contract(
    junction_u: jnp.ndarray,      # [T, S] last junction row, normalized
    junction_scale: jnp.ndarray,  # [T]
    junction_germ: jnp.ndarray,   # [S, G]
    static_log: jnp.ndarray,      # [G] padding-transition etc. log terms
    emis_log: jnp.ndarray,        # [T, G] germline (+padding) emissions
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    f_log = jnp.log(_mm(junction_u, junction_germ)) + static_log[None] + emis_log
    u, m = _normalize(f_log)
    return u, junction_scale + m


def forward(
    trans: Dict[str, jnp.ndarray],
    emis: Dict[str, jnp.ndarray],
    heavy: bool,
) -> Tuple[jnp.ndarray, ForwardCache]:
    """Run the full forward chain.

    ``trans`` (static per family):
      vgerm_static_log [Gv]  log(gene_prob * vpadding_transition *
                             within-region transition product) per V gene
      vgerm_vd [Gv,S1], vd [S1,S1], vd_dgerm [S1,Gd or Gj],
      dgerm_dj [Gd,S2], dj [S2,S2], dj_jgerm [S2,Gj]  (igh only),
      jpadding_log [Gj]  log J padding transition.
    ``emis`` (per tree): vpadding/vgerm [T,Gv], vd_junction [T,R1,S1],
      dgerm [T,Gd], dj_junction [T,R2,S2], jgerm/jpadding [T,Gj].

    Returns per-tree log-likelihood [T] and the forward cache for FFBS.
    """
    vgerm_log = (
        trans["vgerm_static_log"][None]
        + emis["vpadding"]
        + emis["vgerm"]
    )
    vgerm_u, vgerm_scale = _normalize(vgerm_log)

    vd_rows, vd_last, vd_scale = _junction_scan(
        vgerm_u, vgerm_scale, trans["vgerm_vd"], trans["vd"],
        emis["vd_junction"],
    )

    if heavy:
        dgerm_u, dgerm_scale = _germline_contract(
            vd_last, vd_scale, trans["vd_dgerm"],
            jnp.zeros_like(trans["dgerm_dj"][:, 0]), emis["dgerm"],
        )
        dj_rows, dj_last, dj_scale = _junction_scan(
            dgerm_u, dgerm_scale, trans["dgerm_dj"], trans["dj"],
            emis["dj_junction"],
        )
        jgerm_u, jgerm_scale = _germline_contract(
            dj_last, dj_scale, trans["dj_jgerm"],
            trans["jpadding_log"], emis["jgerm"] + emis["jpadding"],
        )
    else:
        dgerm_u = dj_rows = None
        jgerm_u, jgerm_scale = _germline_contract(
            vd_last, vd_scale, trans["vd_dgerm"],
            trans["jpadding_log"], emis["jgerm"] + emis["jpadding"],
        )

    loglik = jgerm_scale + jnp.log(jnp.sum(jgerm_u, axis=-1))
    cache = ForwardCache(
        vgerm_u=vgerm_u,
        vd_u=vd_rows,
        dgerm_u=dgerm_u,
        dj_u=dj_rows,
        jgerm_u=jgerm_u,
    )
    return loglik, cache
