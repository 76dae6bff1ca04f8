"""Multi-host data parallelism over clonal families.

The reference's only repertoire-scale story is one SCons invocation per
family (SURVEY.md section 2g).  Here a repertoire run spans hosts with
jax's distributed runtime: every process loads its slice of the family
list, and one global ``(fam, trees)`` mesh shards the stacked buckets so
that each family lands on one chip group.  The model is KB-scale and
replicated; there is no parameter sharding and no communication in the hot
path — the only collectives are final per-family scalar/tally reductions,
which XLA inserts from the NamedSharding annotations.

Scaling is therefore embarrassingly parallel by construction: the ≥80%
1-chip→2-host efficiency target reduces to keeping per-chip batches full
(bucket families so stacked shapes match; see parallel/repertoire.py).

Because families never need to communicate, the recommended multi-host
pattern is fully independent per-host execution: each process takes its
``process_slice`` of the family list and runs ``run_repertoire`` over a
mesh of its OWN local devices — no global arrays, no cross-host
device_put, results stay host-local::

    from linearham_tpu.parallel import multihost
    from linearham_tpu.parallel.mesh import make_mesh

    multihost.initialize("localhost:1234", num_processes=2, process_id=0)
    mine = multihost.process_slice(all_family_paths)
    mesh = make_mesh(len(jax.local_devices()), 1,
                     devices=jax.local_devices())
    ...load + bucket `mine`, then run_repertoire(tasks, mesh=mesh)

``global_family_mesh`` builds a mesh over ALL devices for the
single-controller case (one process driving several local chips, or a
driver that constructs global arrays itself with
``jax.make_array_from_process_local_data``); do not pass a global mesh to
``run_repertoire`` from per-process code, since it device_puts host-local
stacks and reads back full outputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Start jax's distributed runtime (no-op if already initialized).

    On a GPU or CPU cluster nothing in the environment describes the
    cluster: pass the coordinator address (``host:port``), the process
    count and this process's id.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:  # already initialized -> idempotent
        msg = str(exc).lower()
        if "already" not in msg and "once" not in msg:
            raise


def global_family_mesh(n_tree_shards: int = 1) -> Mesh:
    """A (fam, trees) mesh over ALL devices across every process.

    ``n_tree_shards`` > 1 additionally splits each family's posterior
    tree batch across that many chips (useful when a repertoire has few
    very large families).
    """
    devices = np.asarray(jax.devices())
    if devices.size % n_tree_shards:
        raise ValueError(
            f"{devices.size} devices do not split into "
            f"{n_tree_shards} tree shards")
    grid = devices.reshape(devices.size // n_tree_shards, n_tree_shards)
    return Mesh(grid, ("fam", "trees"))


def pooled_repertoire_summary_multiprocess(logliks_by_family,
                                           rb_by_family) -> dict:
    """Repertoire-wide pooled statistics across ALL processes (SURVEY §2g).

    The single-controller path (``parallel.mesh.pooled_repertoire_summary``)
    reduces on-device over one mesh; in the recommended multi-host pattern
    each process runs its own independent per-host repertoire slice, so the
    repertoire-wide aggregates (total trees, pooled mean LogWeight, mean
    per-family importance-weight ESS — the quantities the bootstrap stage
    consumes, postprocess/bootstrap_asr.py) need one reduction that
    actually crosses process boundaries.  Each process passes its
    host-local per-family log-likelihood / RB-log-likelihood arrays
    (ragged lists are fine: families are host-local, only scalar partials
    travel); the partial sums ride ``multihost_utils.process_allgather``
    over the global device world, and every process returns the SAME
    repertoire-wide summary.

    Single-process calls degrade to a plain local computation, so callers
    need not branch on ``jax.process_count()``.
    """
    n_trees = 0
    sum_lw = 0.0
    n_fam = 0
    sum_ess = 0.0
    for ll, rb in zip(logliks_by_family, rb_by_family):
        lw = np.asarray(ll, float) - np.asarray(rb, float)
        e = np.exp(lw - lw.max())
        n_trees += lw.size
        sum_lw += float(lw.sum())
        n_fam += 1
        sum_ess += float(e.sum() ** 2 / (e * e).sum())
    partial = np.array([n_trees, sum_lw, n_fam, sum_ess])

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        partial = np.asarray(
            multihost_utils.process_allgather(partial)).sum(axis=0)

    n_trees, sum_lw, n_fam, sum_ess = partial
    return {
        "n_trees": float(n_trees),
        "mean_logweight": float(sum_lw / n_trees) if n_trees else 0.0,
        "mean_family_ess": float(sum_ess / n_fam) if n_fam else 0.0,
    }


def process_slice(items: Sequence, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> list:
    """The contiguous slice of ``items`` this host should load.

    Host-side input loading is split evenly by process so no host reads
    the whole repertoire; remainders go to the leading processes.
    """
    p = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    base, rem = divmod(len(items), n)
    start = p * base + min(p, rem)
    return list(items[start:start + base + (1 if p < rem else 0)])
