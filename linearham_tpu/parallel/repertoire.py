"""Repertoire-scale execution: many clonal families per device batch.

Families are bucketed by junction-window row counts (the only dimensions
the forward scan cannot pad) and every other dimension -- state counts,
gene counts, xMSA columns, alignment depth, tree size -- is padded to the
bucket maximum with *dead* elements:

  states    zero transition columns + -inf emissions (never reachable)
  genes     -inf entry log-probability
  xmsa cols gathered by nobody
  tips      ambiguous-N states parented to the sink slot (contribute 1)
  edges     sink->sink no-ops (schedule encoding: entries with penc -1)

One stacked [F, ...] batch then runs through the vmapped fused step and
shards over a (fam, trees) mesh (see parallel.mesh).  The reference's
equivalent is one whole scons invocation per family (SURVEY.md section 2g).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from linearham_tpu.io.trees_tsv import TreeSamples
from linearham_tpu.models.decode import Annotation
from linearham_tpu.models.phylo_hmm import (PhyloHMM, narrow_index,
                                            unpack_path)
from linearham_tpu.parallel.mesh import (multi_family_step_packed,
                                         shard_family_batch)
from linearham_tpu.pipeline.run import prepare_ensemble

NEG = -1e30  # finite stand-in for -inf in padded log tensors

# Module-level jit so repeated run_repertoire calls at the same bucket
# shapes reuse the compiled trace (a per-call jax.jit would retrace).
# The packed variant drains each bucket in ONE host read.
_multi_family_step_jit = jax.jit(
    multi_family_step_packed, static_argnames=("heavy", "n_slots", "mesh"))


@dataclass
class FamilyTask:
    hmm: PhyloHMM
    samples: TreeSamples


@dataclass
class FamilyResult:
    loglik: np.ndarray            # [T]
    logweight: np.ndarray         # [T]
    annotations: List[Annotation]


def _pad(a: np.ndarray, shape: Tuple[int, ...], fill=0.0) -> np.ndarray:
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _pad_repeat(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Grow ``axis`` to ``size`` by repeating its last element."""
    if a.ndim <= axis or a.shape[axis] == size:
        return a
    idx = np.minimum(np.arange(size), a.shape[axis] - 1)
    return np.take(a, idx, axis=axis)


def _bucket_key(hmm: PhyloHMM) -> Tuple:
    sp = hmm.space
    heavy = sp.is_heavy
    return (
        heavy,
        sp.vd_junction.n_rows,
        sp.dj_junction.n_rows if heavy else -1,
    )


def _stack_bucket(tasks: List[FamilyTask], num_rates: int, dtype):
    """Pad + stack all per-family device inputs for one bucket."""
    hmms = [t.hmm for t in tasks]
    heavy = hmms[0].space.is_heavy
    preps = [prepare_ensemble(t.hmm, t.samples, num_rates) for t in tasks]

    # Real RevBayes ensembles vary in size per family; pad every family's
    # tree axis to the bucket maximum by repeating its last sample (the
    # duplicates are dead weight -- run_repertoire slices results to each
    # family's true count).
    T_max = max(p[2].shape[0] for p in preps)

    def pad_trees(a: np.ndarray, t_own: int) -> np.ndarray:
        del t_own  # the repeat source is always the last real element
        return _pad_repeat(a, 0, T_max)

    preps = [
        (
            {k: pad_trees(v, p[2].shape[0]) for k, v in p[0].items()},
            jax.tree.map(
                lambda a: pad_trees(np.asarray(a), p[2].shape[0]), p[1]),
            pad_trees(p[2], p[2].shape[0]),
            p[3],
        )
        for p in preps
    ]
    pi_list = [
        pad_trees(np.asarray(t.samples.pi), t.samples.n_samples)
        for t in tasks
    ]

    def gather(fn):
        return [fn(h) for h in hmms]

    # The families' HOST copies: no device round trip per array.
    trans_list = [dict(h._trans_np) for h in hmms]
    consts_list = [h._consts_np for h in hmms]
    xmsa_list = gather(lambda h: h._xmsa_rows_np)
    naive_list = gather(lambda h: h._naive_bases_np)

    def maxdim(arrs, axis):
        return max(a.shape[axis] for a in arrs)

    Gv = maxdim([t["vgerm_static_log"] for t in trans_list], 0)
    S1 = maxdim([t["vd"] for t in trans_list], 0)
    Gj = maxdim([t["jpadding_log"] for t in trans_list], 0)
    if heavy:
        Gd = maxdim([t["dgerm_dj"] for t in trans_list], 0)
        S2 = maxdim([t["dj"] for t in trans_list], 0)
    X = maxdim(xmsa_list, 1)
    n_msa_rows = maxdim(xmsa_list, 0)
    n_slots = max(p[3] for p in preps)
    sink = n_slots - 1

    trans = {}
    trans["vgerm_static_log"] = np.stack([
        _pad(t["vgerm_static_log"], (Gv,), NEG) for t in trans_list])
    trans["vgerm_vd"] = np.stack([
        _pad(t["vgerm_vd"], (Gv, S1)) for t in trans_list])
    trans["vd"] = np.stack([_pad(t["vd"], (S1, S1)) for t in trans_list])
    g_after_vd = Gd if heavy else Gj
    trans["vd_dgerm"] = np.stack([
        _pad(t["vd_dgerm"], (S1, g_after_vd)) for t in trans_list])
    trans["jpadding_log"] = np.stack([
        _pad(t["jpadding_log"], (Gj,), NEG) for t in trans_list])
    if heavy:
        trans["dgerm_dj"] = np.stack([
            _pad(t["dgerm_dj"], (Gd, S2)) for t in trans_list])
        trans["dj"] = np.stack([
            _pad(t["dj"], (S2, S2)) for t in trans_list])
        trans["dj_jgerm"] = np.stack([
            _pad(t["dj_jgerm"], (S2, Gj)) for t in trans_list])

    def stack_linear(name, n_genes):
        # Each family's one-hot contraction map pads with zero rows/cols:
        # padded xMSA columns and padded genes contribute nothing.
        return {"m": np.stack([
            _pad(c[name]["m"], (X, n_genes)) for c in consts_list])}

    def stack_junction(name, rows, n_states):
        # Pad the [rows, S] index maps with -1 (dead cells, masked out);
        # family-local xMSA column indices stay valid in the padded
        # batch because each family occupies the leading columns.
        inds_list, masks = [], []
        for c in consts_list:
            inds_list.append(
                _pad(np.asarray(c[name]["inds"]), (rows, n_states), -1))
            masks.append(_pad(c[name]["mask"], (rows, n_states), False))
        return {"inds": np.stack(inds_list), "mask": np.stack(masks)}

    r1 = hmms[0].space.vd_junction.n_rows
    consts = {
        "vpadding": stack_linear("vpadding", Gv),
        "vgerm": stack_linear("vgerm", Gv),
        "vd_junction": stack_junction("vd_junction", r1, S1),
        "jgerm": stack_linear("jgerm", Gj),
        "jpadding": stack_linear("jpadding", Gj),
    }
    if heavy:
        r2 = hmms[0].space.dj_junction.n_rows
        consts["dgerm"] = stack_linear("dgerm", Gd)
        consts["dj_junction"] = stack_junction("dj_junction", r2, S2)

    xmsa_rows = np.stack([
        _pad(a, (n_msa_rows, X), 4) for a in xmsa_list])
    naive_bases = np.stack([_pad(a, (X,), 4) for a in naive_list])

    if "sched_src" in preps[0][0]:
        # Slot-reuse schedule encoding (io/schedule.py): pad every
        # family's entry list to the bucket maximum with skipped (-1)
        # entries.
        N = maxdim([p[0]["sched_src"] for p in preps], 1)
        tree = {
            "sched_src": narrow_index(np.stack([
                _pad(np.asarray(p[0]["sched_src"]),
                     (T_max, N), 0) for p in preps])),
            "sched_penc": narrow_index(np.stack([
                _pad(np.asarray(p[0]["sched_penc"], np.int32),
                     (T_max, N), -1) for p in preps])),
            "sched_len": np.stack([
                _pad(p[0]["sched_len"], (T_max, N), 0.0) for p in preps]),
            "sched_root": narrow_index(np.stack(
                [p[0]["sched_root"] for p in preps])),
        }
    else:
        n_tips = maxdim([p[0]["tip_perm"] for p in preps], 1)
        e_max = maxdim([p[0]["edge_child"] for p in preps], 1)
        tree = {}
        for key, fill in (("tip_perm", 0), ("tip_parent", sink),
                          ("tip_length", 0.0), ("edge_child", sink),
                          ("edge_parent", sink), ("edge_length", 0.0),
                          ("root_slot", 0)):
            arrs = [p[0][key] for p in preps]
            if key == "root_slot":
                tree[key] = np.stack(arrs)
                continue
            width = n_tips if key.startswith("tip") else e_max
            padded = []
            for a, p in zip(arrs, preps):
                out = _pad(a, (a.shape[0], width), fill)
                if key == "tip_perm":
                    # Padded tips read a padded (all-N) alignment row.
                    out[:, a.shape[1]:] = n_msa_rows - 1
                padded.append(out)
            tree[key] = np.stack(padded)

        # Re-point per-family sink slots at the batch-wide sink.
        for f, p in enumerate(preps):
            own_sink = p[3] - 1
            if own_sink != sink:
                for key in ("edge_child", "edge_parent"):
                    body = tree[key][f]
                    body[body == own_sink] = sink
                tp = tree["tip_parent"][f]
                tp[tp == own_sink] = sink

    eig = jax.tree.map(
        lambda *xs: np.stack(xs), *[p[1] for p in preps])
    rates = np.stack([p[2] for p in preps])
    pi = np.stack(pi_list)
    return trans, consts, xmsa_rows, naive_bases, tree, eig, pi, rates, \
        n_slots


def run_repertoire(
    tasks: List[FamilyTask],
    num_rates: int = 4,
    seed: int = 0,
    mesh=None,
    dtype=jnp.float64,
    timings: Optional[dict] = None,
) -> List[FamilyResult]:
    """Run many families; buckets execute as stacked vmapped steps.

    ``timings`` (optional dict) accumulates per-stage seconds with the
    pipeline-mode stage names: stack_families (host pad/stack),
    device_transfer (host dtype casts + the single packed put per
    bucket), device_step (dispatch + the single packed host read),
    decode (host path decode per family).
    """
    import threading

    from linearham_tpu.utils.profiling import StageTimer

    # Initialize the backend and warm the transfer path on a side thread,
    # overlapping the host-side bucket stacking (as run_pipeline does).
    def _dial():
        try:
            jax.block_until_ready(jax.device_put(np.zeros(8, np.float32)))
        except Exception:
            pass

    threading.Thread(target=_dial, daemon=True).start()
    timer = StageTimer()
    buckets: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tasks):
        buckets.setdefault(_bucket_key(t.hmm), []).append(i)

    results: List[Optional[FamilyResult]] = [None] * len(tasks)
    key = None   # created after the first host-side stack: PRNGKey blocks
    for bkey, idxs in buckets.items():   # on backend initialization,
        # which the side thread above is still running.
        heavy = bkey[0]
        group = [tasks[i] for i in idxs]
        with timer.stage("stack_families"):
            (trans, consts, xmsa_rows, naive_bases, tree, eig, pi, rates,
             n_slots) = _stack_bucket(group, num_rates, dtype)
        n_keys = len(group)
        if key is None:
            key = jax.random.PRNGKey(seed)

        if mesh is not None:
            # NamedSharding needs each sharded axis divisible by its mesh
            # axis; pad the family axis (repeat the last family) and the
            # padded tree axis (repeat the last sample) up to multiples —
            # all dead weight, sliced off below.
            n_f = mesh.shape["fam"]
            n_t = mesh.shape["trees"]
            F_pad = -(-len(group) // n_f) * n_f
            T_pad = -(-rates.shape[1] // n_t) * n_t
            n_keys = F_pad

            def pad_f(a):
                return _pad_repeat(np.asarray(a), 0, F_pad)

            def pad_ft(a):
                return _pad_repeat(
                    _pad_repeat(np.asarray(a), 0, F_pad), 1, T_pad)

            trans, consts, xmsa_rows, naive_bases = jax.tree.map(
                pad_f, (trans, consts, xmsa_rows, naive_bases))
            tree, eig, pi, rates = jax.tree.map(
                pad_ft, (tree, eig, pi, rates))

        def to_host(a):
            a = np.asarray(a)
            # copy=False: the common case (data already in the compute
            # dtype) must not pay an extra full host copy here — the
            # packed put below concatenates (and therefore copies) once.
            return a.astype(dtype, copy=False) if np.issubdtype(
                a.dtype, np.floating) else a

        with timer.stage("device_transfer"):
            host_args = jax.tree.map(
                to_host, (trans, consts, xmsa_rows, naive_bases, tree,
                          eig, pi, rates))
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, n_keys)

            if mesh is not None:
                args = shard_family_batch(mesh, *host_args, keys)
            else:
                from linearham_tpu.utils.wire import device_put_packed

                args = (*device_put_packed(host_args), keys)

        with timer.stage("device_step"):
            from linearham_tpu.utils.exec_cache import cached_call

            packed = np.asarray(cached_call(
                _multi_family_step_jit, "multi_family_step",
                dict(heavy=heavy, n_slots=n_slots, mesh=mesh),
                *args))                                # ONE host read

        f64 = dtype == jnp.float64
        with timer.stage("decode"):
            for f, i in enumerate(idxs):
                task = tasks[i]
                T = task.samples.n_samples
                loglik, fam_path = unpack_path(
                    packed[f, :T], task.hmm.space.is_heavy,
                    task.hmm.space.vd_junction.n_rows, f64=f64)
                results[i] = FamilyResult(
                    loglik=loglik,
                    logweight=loglik - task.samples.rb_loglik,
                    annotations=task.hmm._decode_batch(fam_path),
                )
    if timings is not None:
        for k, v in timer.as_dict().items():
            timings[k] = timings.get(k, 0.0) + v
    return results


def write_family_output(task: FamilyTask, result: FamilyResult,
                        num_rates: int, out_path: str) -> None:
    """Write one family's reference-format pipeline TSV.

    Same column contract as the single-family pipeline
    (src/PhyloHMM.cpp:244-327); atomic .partial -> rename."""
    from linearham_tpu.ops.gtr import gamma_category_rates_batch
    from linearham_tpu.pipeline.run import write_tsv_header, write_tsv_rows
    from linearham_tpu.utils.fileio import atomic_write

    rates = gamma_category_rates_batch(task.samples.alpha, num_rates)
    heavy = task.hmm.space.is_heavy
    with atomic_write(out_path) as fh:
        write_tsv_header(num_rates, heavy, fh)
        write_tsv_rows(task.samples, rates, result.loglik,
                       result.logweight, result.annotations, 0,
                       task.samples.n_samples, heavy, fh)
