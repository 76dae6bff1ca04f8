"""Batched Felsenstein pruning over xMSA columns (the phylo hot kernel).

Computes per-site phylogenetic log-likelihoods for every xMSA column under
GTR+Gamma, vectorized over sites and rate categories and vmapped over the
posterior tree batch.  This replaces libpll's TraversalUpdate/LogLikelihood
(reference boundary: src/PhyloHMM.cpp:220-238).

Layout: partials are states-major [slots, R, 4, X] so the long site axis
is the minor (contiguous) one.  Transition matrices are never
materialized per edge: each message is propagated through the GTR
eigenbasis as three [4, X] contractions,

    msg = U @ (exp(lam * t * r) * (Uinv @ partial)),

which stores only the per-edge eigenvalue scalings.  This is the f64
conformance path and the reference the GPU kernel (ops/pruning_kernel.py)
is tested against.

Encoding (see io.newick.TreeBatch): every tip has exactly one parent edge,
so tip contributions are one batched einsum + segment-product; the
remaining internal edges are walked with lax.scan in post-order with
per-site renormalization feeding an explicit log-scale accumulator.

Ambiguity: tip code >= 4 (N) means an all-ones partial (gap semantics, as
the reference's treatAmbiguousAsGap; rows of P(t) sum to 1 so an N tip
contributes exactly 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

from linearham_tpu.ops.gtr import GTREigen


def tip_onehot(tip_states: jnp.ndarray, dtype) -> jnp.ndarray:
    """One-hot tip partials [n_tips, 4, X]; ambiguous (>=4) rows are ones."""
    codes = jax.lax.broadcasted_iota(jnp.int32, (1, 4, 1), 1)
    return jnp.where(
        (tip_states[:, None, :] == codes) | (tip_states[:, None, :] >= 4),
        jnp.ones((), dtype), jnp.zeros((), dtype))


def compute_partials(
    eig: GTREigen,            # u/u_inv [4,4], lam [4] for this tree
    rates: jnp.ndarray,       # [R]
    tip_states: jnp.ndarray,  # [n_tips, X] xMSA codes permuted to tip slots
    tip_parent: jnp.ndarray,  # [n_tips] internal slot ids
    tip_length: jnp.ndarray,  # [n_tips]
    edge_child: jnp.ndarray,  # [E] internal slots (post-order)
    edge_parent: jnp.ndarray, # [E]
    edge_length: jnp.ndarray, # [E]
    n_slots: int,             # static: internal slots incl. sink
):
    """Upward (Felsenstein) pass for one tree.

    Returns (partials [slots, R, 4, X], scale [R, X]); each internal slot
    holds the likelihood of the data below it conditional on its state,
    max-normalized with the log-scale accumulated per (rate, site).
    """
    dtype = eig.u.dtype

    onehot = tip_onehot(tip_states, dtype)

    # --- tips: propagate all tip messages in one shot --------------------
    expd_tip = jnp.exp(
        eig.lam[None, None, :]
        * (tip_length[:, None] * rates[None, :])[..., None]
    )                                                  # [tips, R, 4]
    w = jnp.einsum("ij,tjx->tix", eig.u_inv, onehot,
                   precision=_HI)                      # [tips, 4, X]
    w = w[:, None, :, :] * expd_tip[..., None]         # [tips, R, 4, X]
    msg = jnp.einsum("ij,trjx->trix", eig.u, w, precision=_HI)
    # Low-precision cancellation in the eigenbasis could go (slightly)
    # negative; true propagated partials are nonnegative.
    msg = jnp.maximum(msg, 0.0)
    partials = jax.ops.segment_prod(
        msg, tip_parent, num_segments=n_slots)         # [slots, R, 4, X]

    norm = jnp.max(partials, axis=-2, keepdims=True)
    norm = jnp.where(norm > 0, norm, 1.0)
    partials = partials / norm
    scale = jnp.sum(jnp.log(norm[:, :, 0, :]), axis=0)  # [R, X]

    # --- internal edges: post-order scan ---------------------------------
    expd_edge = jnp.exp(
        eig.lam[None, None, :]
        * (edge_length[:, None] * rates[None, :])[..., None]
    )                                                  # [E, R, 4]

    def step(carry, inp):
        partials, scale = carry
        child, parent, expd = inp                      # expd: [R, 4]
        w = jnp.einsum("ij,rjx->rix", eig.u_inv, partials[child],
                       precision=_HI)
        w = w * expd[..., None]
        msg = jnp.maximum(
            jnp.einsum("ij,rjx->rix", eig.u, w, precision=_HI), 0.0)
        upd = partials[parent] * msg
        m = jnp.max(upd, axis=-2, keepdims=True)
        m = jnp.where(m > 0, m, 1.0)
        partials = partials.at[parent].set(upd / m)
        scale = scale + jnp.log(m[:, 0, :])
        return (partials, scale), None

    (partials, scale), _ = jax.lax.scan(
        step, (partials, scale), (edge_child, edge_parent, expd_edge)
    )
    return partials, scale


def per_rate_root_loglik(partials, scale, pi, root_slot):
    """Per-(rate, site) log-likelihood [R, X] at the root."""
    root = partials[root_slot]                         # [R, 4, X]
    return jnp.log(
        jnp.einsum("i,rix->rx", pi, root, precision=_HI)) + scale


def site_log_likelihoods(
    eig: GTREigen,
    pi: jnp.ndarray,
    rates: jnp.ndarray,
    tip_states: jnp.ndarray,
    tip_parent: jnp.ndarray,
    tip_length: jnp.ndarray,
    edge_child: jnp.ndarray,
    edge_parent: jnp.ndarray,
    edge_length: jnp.ndarray,
    root_slot: jnp.ndarray,
    n_slots: int,
) -> jnp.ndarray:
    """Per-site rate-mixed log-likelihood [X] for one tree."""
    partials, scale = compute_partials(
        eig, rates, tip_states, tip_parent, tip_length,
        edge_child, edge_parent, edge_length, n_slots,
    )
    per_rate = per_rate_root_loglik(partials, scale, pi, root_slot)
    R = rates.shape[0]
    return jax.scipy.special.logsumexp(per_rate, axis=0) - jnp.log(
        jnp.asarray(R, eig.u.dtype))
