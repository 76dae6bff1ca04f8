"""Ancestral sequence reconstruction: joint posterior state sampling.

Given a tree, GTR+Gamma parameters, and the alignment with the naive row
set to a linearham-sampled naive sequence, draws one joint sample of all
ancestral (internal-node) states per site:

  1. per site, sample the rate category proportional to the per-category
     likelihood (the naive-prior correction cancels inside the categorical);
  2. sample the root state from pi x root-partial;
  3. walk edges root-down (reverse post-order), sampling each child from
     P(t * r_site)[parent state, .] x child partial; tips with observed
     bases collapse to them, ambiguous tips are resolved by sampling.

This is the batched device replacement for the reference's per-site R loop
(scripts/run_bootstrap_asr_ess.R:67-88, phylomd::asr.sim) -- here one
batched call covers all sites x all bootstrap trees.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from linearham_tpu.ops.gtr import GTREigen
from linearham_tpu.ops.pruning import (
    compute_partials,
    per_rate_root_loglik,
    tip_onehot,
)

_HI = jax.lax.Precision.HIGHEST


class ASRSample(NamedTuple):
    internal_states: jnp.ndarray   # [n_slots, X] int codes
    tip_states: jnp.ndarray        # [n_tips, X] (ambiguities resolved)
    rate_idx: jnp.ndarray          # [X] sampled rate category per site


def _edge_cond_logits(eig, expd_site, parent_states, child_partial):
    """log P[parent_state, c] + log partial_child[c] per site.

    expd_site: [X, 4] eigenvalue scalings at each site's sampled rate;
    parent_states: [X]; child_partial: [4, X].  Returns [X, 4].
    """
    u_rows = eig.u[parent_states, :]                  # [X, 4]
    w = u_rows * expd_site                            # [X, 4]
    pvec = jnp.einsum("xk,kc->xc", w, eig.u_inv, precision=_HI)
    pvec = jnp.maximum(pvec, 0.0)
    return jnp.log(pvec) + jnp.log(
        jnp.maximum(child_partial.T, 0.0))


def sample_ancestral_states(
    key: jnp.ndarray,
    eig: GTREigen,
    pi: jnp.ndarray,
    rates: jnp.ndarray,
    tip_states: jnp.ndarray,   # [n_tips, X] with 4 == ambiguous
    tip_parent: jnp.ndarray,
    tip_length: jnp.ndarray,
    edge_child: jnp.ndarray,
    edge_parent: jnp.ndarray,
    edge_length: jnp.ndarray,
    root_slot: jnp.ndarray,
    n_slots: int,
) -> ASRSample:
    """One joint ancestral sample for one tree (vmap over a batch)."""
    X = tip_states.shape[1]
    dtype = eig.u.dtype
    k_rate, k_root, k_edges, k_tips = jax.random.split(key, 4)

    partials, scale = compute_partials(
        eig, rates, tip_states, tip_parent, tip_length,
        edge_child, edge_parent, edge_length, n_slots,
    )

    # 1. Rate category per site.
    per_rate = per_rate_root_loglik(partials, scale, pi, root_slot)  # [R, X]
    rate_idx = jax.random.categorical(k_rate, per_rate.T, axis=-1)   # [X]
    lam_r = eig.lam[None, :] * rates[rate_idx][:, None]              # [X, 4]

    # 2. Root state per site.
    root_partial = jnp.take_along_axis(
        partials[root_slot], rate_idx[None, None, :], axis=0)[0]     # [4, X]
    root_logits = jnp.log(pi[None, :]) + jnp.log(
        jnp.maximum(root_partial.T, 0.0))
    root_states = jax.random.categorical(k_root, root_logits, axis=-1)

    states = jnp.zeros((n_slots, X), jnp.int32)
    states = states.at[root_slot].set(root_states.astype(jnp.int32))

    # 3. Internal edges, root-down.
    n_edges = edge_child.shape[0]
    edge_keys = jax.random.split(k_edges, max(n_edges, 1))

    def step(states, inp):
        child, parent, length, subkey = inp
        child_partial = jnp.take_along_axis(
            partials[child], rate_idx[None, None, :], axis=0)[0]     # [4, X]
        logits = _edge_cond_logits(
            eig, jnp.exp(lam_r * length), states[parent], child_partial)
        s = jax.random.categorical(subkey, logits, axis=-1)
        return states.at[child].set(s.astype(jnp.int32)), None

    states, _ = jax.lax.scan(
        step, states,
        (edge_child[::-1], edge_parent[::-1], edge_length[::-1], edge_keys),
    )

    # 4. Tips in one batched draw (observed bases win automatically).
    onehot = tip_onehot(tip_states, dtype)                 # [tips, 4, X]
    parent_states = states[tip_parent]                     # [tips, X]
    u_rows = eig.u[parent_states, :]                       # [tips, X, 4]
    expd = jnp.exp(lam_r[None] * tip_length[:, None, None])  # [tips, X, 4]
    w = u_rows * expd
    pvec = jnp.maximum(
        jnp.einsum("txk,kc->txc", w, eig.u_inv, precision=_HI), 0.0)
    tip_logits = jnp.log(pvec) + jnp.log(
        jnp.maximum(jnp.swapaxes(onehot, 1, 2), 0.0))
    tip_sampled = jax.random.categorical(k_tips, tip_logits, axis=-1)

    return ASRSample(
        internal_states=states,
        tip_states=tip_sampled.astype(jnp.int32),
        rate_idx=rate_idx.astype(jnp.int32),
    )
