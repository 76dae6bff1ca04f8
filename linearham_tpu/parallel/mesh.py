"""Device-mesh sharding for repertoire-scale runs.

The model is tiny (germline parameter pytrees, KB-scale); all scaling is
data parallelism over two structural axes:

  fam    clonal families, padded into identical-shape buckets and stacked
         on a leading axis (the repertoire axis; spans hosts in production)
  trees  posterior tree samples within each family

Both are embarrassingly parallel.  XLA's partitioner lays out the step
from NamedSharding annotations alone, with one exception: it cannot
partition the pruning kernel's custom call, and would gather its inputs
and run the whole batch on every device.  Pruning therefore runs under
``shard_map`` over the (fam, trees) blocks, and the rest of the step
(emissions, forward, FFBS) under the partitioner, which keeps the random
draws identical to an unsharded run.  Cross-device reductions (pooled
naive-sequence tallies, importance-weight ESS) are jnp ops over sharded
arrays.  The reference has no distributed execution at all (SURVEY.md
section 2g); this module replaces its one-scons-invocation-per-family
process parallelism.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from linearham_tpu.models.phylo_hmm import (pack_step, site_logliks,
                                            step_from_site_ll)


def make_mesh(n_fam: int, n_trees: int, devices=None) -> Mesh:
    """A (fam, trees) mesh over the first n_fam*n_trees devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < n_fam * n_trees:
        raise ValueError(
            f"need {n_fam * n_trees} devices, have {devices.size}")
    grid = devices[: n_fam * n_trees].reshape(n_fam, n_trees)
    return Mesh(grid, ("fam", "trees"))


def family_site_logliks(xmsa_rows, tree, eig, pi, rates, n_slots: int,
                        mesh: Optional[Mesh] = None):
    """Pruning for a stacked family batch: site log-likelihoods [F, T, X].

    With a mesh, each device prunes its own (fam, trees) block.
    """
    prune = jax.vmap(partial(site_logliks, n_slots=n_slots))
    if mesh is not None:
        fam, fam_trees = P("fam"), P("fam", "trees")
        prune = shard_map(
            prune, mesh=mesh,
            in_specs=(fam, fam_trees, fam_trees, fam_trees, fam_trees),
            out_specs=fam_trees)
    return prune(xmsa_rows, tree, eig, pi, rates)


def multi_family_step(trans, consts, xmsa_rows, naive_bases, tree, eig, pi,
                      rates, keys, heavy: bool, n_slots: int,
                      mesh: Optional[Mesh] = None):
    """The fused pipeline step over a stacked family axis.

    Every array carries a leading [F] axis; tree/GTR arrays carry [F, T].
    Returns (loglik [F, T], sampled paths with [F, T] leading axes).
    """
    site_ll = family_site_logliks(xmsa_rows, tree, eig, pi, rates, n_slots,
                                  mesh)

    def one_family(trans_f, consts_f, naive_f, site_ll_f, pi_f, key_f):
        loglik, _, path = step_from_site_ll(
            trans_f, consts_f, naive_f, site_ll_f, pi_f, key_f, heavy)
        return loglik, path

    return jax.vmap(one_family)(trans, consts, naive_bases, site_ll, pi,
                                keys)


def multi_family_step_packed(trans, consts, xmsa_rows, naive_bases, tree,
                             eig, pi, rates, keys, heavy: bool,
                             n_slots: int, mesh: Optional[Mesh] = None):
    """multi_family_step with results packed into ONE int [F, T, C] array
    (loglik bit-cast into the leading column(s)) — a single host read per
    bucket; see models.phylo_hmm.pack_step for the layout and unpack_path
    for the inverse."""
    loglik, path = multi_family_step(
        trans, consts, xmsa_rows, naive_bases, tree, eig, pi, rates, keys,
        heavy=heavy, n_slots=n_slots, mesh=mesh)
    return jax.vmap(partial(pack_step, heavy=heavy))(trans, loglik, path)


def shard_family_batch(mesh: Mesh, trans, consts, xmsa_rows, naive_bases,
                       tree, eig, pi, rates, keys):
    """device_put the stacked inputs with (fam, trees) shardings.

    Family-constant tensors shard over 'fam' only; per-tree tensors shard
    over ('fam', 'trees') on their first two axes.
    """
    fam = NamedSharding(mesh, P("fam"))
    fam_trees = NamedSharding(mesh, P("fam", "trees"))

    put_fam = partial(jax.tree.map, lambda a: jax.device_put(a, fam))
    put_ft = partial(jax.tree.map, lambda a: jax.device_put(a, fam_trees))
    return (
        put_fam(trans), put_fam(consts), put_fam(xmsa_rows),
        put_fam(naive_bases), put_ft(tree), put_ft(eig), put_ft(pi),
        put_ft(rates), put_fam(keys),
    )


def sharded_pipeline(mesh: Mesh, heavy: bool, n_slots: int):
    """jit multi_family_step on ``mesh`` with (fam, trees)-sharded
    outputs; pruning runs per device under shard_map."""
    out_spec = NamedSharding(mesh, P("fam", "trees"))
    step = partial(multi_family_step, heavy=heavy, n_slots=n_slots,
                   mesh=mesh)
    return jax.jit(step, out_shardings=(out_spec, None))


def pooled_repertoire_summary(mesh: Mesh, loglik, rb_loglik) -> dict:
    """Repertoire-wide pooled statistics, reduced on-device (SURVEY §2g).

    The per-step hot path is embarrassingly parallel by design — zero
    collectives — but repertoire-level aggregates need one cross-device
    reduction, and doing it on the mesh (psum/pmax inside shard_map)
    avoids gathering the full [F, T] result arrays to one
    host.  Computes, over (fam, trees)-sharded log-likelihoods:

      * total tree count,
      * pooled mean LogWeight,
      * per-family importance-weight ESS = (Σw)²/Σw² of the softmax
        weights (the quantity the bootstrap stage subsamples by,
        postprocess/bootstrap_asr.py), pooled to its mean.

    The tree axis is sharded too, so the per-family softmax runs as a
    distributed logsumexp: pmax for the stabilizing max, psum for the
    exp sums.
    """
    spec = P("fam", "trees")

    @partial(shard_map, mesh=mesh, in_specs=(spec, spec),
             out_specs=(P(), P(), P()))
    def summary(ll, rb):
        lw = ll - rb                                       # [f_l, t_l]
        m = jax.lax.pmax(jnp.max(lw, axis=1, keepdims=True), "trees")
        e = jnp.exp(lw - m)
        s1 = jax.lax.psum(jnp.sum(e, axis=1, keepdims=True), "trees")
        s2 = jax.lax.psum(jnp.sum(e * e, axis=1, keepdims=True), "trees")
        ess = (s1 * s1) / s2                               # [f_l, 1]
        n = jax.lax.psum(
            jnp.asarray(lw.size, lw.dtype), ("fam", "trees"))
        mean_lw = jax.lax.psum(jnp.sum(lw), ("fam", "trees")) / n
        n_fam = jax.lax.psum(jnp.asarray(ess.size, lw.dtype), "fam")
        mean_ess = jax.lax.psum(jnp.sum(ess), "fam") / n_fam
        return n, mean_lw, mean_ess

    n, mean_lw, mean_ess = jax.jit(summary)(loglik, rb_loglik)
    return {
        "n_trees": float(n),
        "mean_logweight": float(mean_lw),
        "mean_family_ess": float(mean_ess),
    }
