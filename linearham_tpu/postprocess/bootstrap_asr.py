"""Importance-weighted bootstrap + ESS + ancestral sequence reconstruction.

The batched device replacement for the reference's R post-processing stage
(scripts/run_bootstrap_asr_ess.R): drop burn-in, subsample tree samples
without replacement with probabilities softmax(LogWeight), report
weight-adjusted effective sample sizes, and for each subsampled tree draw
one joint ancestral-sequence sample -- here as ONE batched device call
over all (tree, site) pairs instead of an R loop over sites.

Outputs match the reference's artifact contract: ``<base>.trees`` with one
``[&ancestral="SEQ"]``-annotated Newick per line, ``<base>.log`` with the
subsampled posterior rows, and ``<base>.ess``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from linearham_tpu.io.annotated_newick import (
    parse_annotated_newick,
    reroot_at_tip,
    write_annotated_newick,
)
from linearham_tpu.io.newick import collapse_unary, tree_arrays_from_node
from linearham_tpu.ops.asr import sample_ancestral_states
from linearham_tpu.ops.gtr import gtr_eigen
from linearham_tpu.utils.seqs import read_fasta
from linearham_tpu.utils.stats import effective_sample_size

_NON_NUMERIC = {"tree", "NaiveSequence", "VGene", "DGene", "JGene",
                "VFwkInsertion", "VDInsertion", "DJInsertion",
                "VJInsertion", "JFwkInsertion"}
_DROPPED = {"Iteration", "tree", "NaiveSequence"}


def _read_rows(path: str) -> List[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def _log_sum_exp(v: np.ndarray) -> float:
    m = v.max()
    return m + np.log(np.exp(v - m).sum())


@dataclass
class BootstrapResult:
    rows: List[dict]              # subsampled posterior rows
    annotated_trees: List[str]
    ess: Dict[str, float]


def run_bootstrap_asr(
    pipeline_tsv: str,
    fasta_path: str,
    burnin_frac: float,
    subsamp_frac: float,
    seed: int,
    output_base: Optional[str] = None,
    dtype=jnp.float64,
    output_trees_path: Optional[str] = None,
    output_log_path: Optional[str] = None,
    output_ess_path: Optional[str] = None,
) -> BootstrapResult:
    """Full bootstrap/ESS/ASR stage; writes <base>.{trees,log,ess}."""
    rng = np.random.default_rng(seed)
    rows = _read_rows(pipeline_tsv)
    if not rows:
        raise ValueError(f"{pipeline_tsv} has no posterior rows")
    rows = rows[int(burnin_frac * len(rows)):]
    n = len(rows)

    # Importance weights -> bootstrap subsample without replacement.
    logw = np.array([float(r["LogWeight"]) for r in rows])
    probs = np.exp(logw - _log_sum_exp(logw))
    n_boot = max(1, int(subsamp_frac * n))
    boot_idx = rng.choice(n, size=n_boot, replace=False, p=probs)
    boot_rows = [rows[i] for i in boot_idx]

    # Weight-adjusted ESS over the numeric posterior columns.  Rows with
    # non-finite entries are removed before the autocorrelation fit -- the
    # reference drops such ROWS, not columns (a -inf LHLogLikelihood once
    # crashed coda's lm.fit; run_bootstrap_asr_ess.R:36-40).
    w2 = float((probs ** 2).sum())
    num_cols = [c for c in rows[0]
                if c not in _DROPPED and c not in _NON_NUMERIC]
    mat = np.array([[float(r[c]) for c in num_cols] for r in rows])
    finite = np.isfinite(mat).all(axis=1)
    if not finite.all():
        import sys

        print(f"WARNING removed {int((~finite).sum())} / {len(rows)} rows "
              "with nan/inf entries when calculating ess values",
              file=sys.stderr)
    mat = mat[finite]
    ess = {}
    if len(mat):
        for j, col in enumerate(num_cols):
            ess[col] = round(
                effective_sample_size(mat[:, j]) / len(mat) / w2)

    annotated = _asr_annotate(boot_rows, fasta_path, seed, dtype)

    if output_base is not None:
        output_trees_path = output_trees_path or output_base + ".trees"
        output_log_path = output_log_path or output_base + ".log"
        output_ess_path = output_ess_path or output_base + ".ess"
    if output_trees_path is not None:
        with open(output_trees_path, "w") as fh:
            fh.write("\n".join(annotated) + "\n")
    if output_log_path is not None:
        log_cols = [c for c in rows[0] if c not in _DROPPED]
        with open(output_log_path, "w") as fh:
            fh.write("\t".join(log_cols) + "\n")
            for r in boot_rows:
                fh.write("\t".join(str(r[c]) for c in log_cols) + "\n")
    if output_ess_path is not None:
        with open(output_ess_path, "w") as fh:
            fh.write("Parameter\tESS\n")
            for k, v in ess.items():
                fh.write(f"{k}\t{v:g}\n")

    return BootstrapResult(rows=boot_rows, annotated_trees=annotated,
                           ess=ess)


def _asr_annotate(boot_rows: List[dict], fasta_path: str, seed: int,
                  dtype) -> List[str]:
    """Sample ancestral sequences for every bootstrap tree (one device
    call per topology-shape group) and annotate the Newick strings."""
    seqs = read_fasta(fasta_path)
    alphabet = "ACGT"
    lut = {c: i for i, c in enumerate(alphabet)}

    def encode(s: str) -> np.ndarray:
        return np.array([lut.get(c.upper(), 4) for c in s], np.int32)

    n_rates = len([c for c in boot_rows[0] if c.startswith("sr[")])

    parsed = []
    for r in boot_rows:
        # Reroot at the naive outgroup before simulating ancestors, as the
        # reference does (run_bootstrap_asr_ess.R:51-53).  Under the
        # reversible GTR model the joint ancestral law is invariant to the
        # rooting; this fixes the OUTPUT topology contract (annotated trees
        # are naive-rooted) for the downstream lineage walk.
        root = reroot_at_tip(
            collapse_unary(parse_annotated_newick(r["tree"])), "naive")
        arrays, tip_nodes, internal_nodes = tree_arrays_from_node(root)
        parsed.append((root, arrays, tip_nodes, internal_nodes))

    # Group by (n_internal, n_edges) so each group batches one jit shape.
    L = len(next(iter(seqs.values())))
    key = jax.random.PRNGKey(seed)
    out = [None] * len(boot_rows)
    groups: Dict[tuple, List[int]] = {}
    for i, (_, arrays, _, _) in enumerate(parsed):
        shape = (arrays.n_internal, len(arrays.edge_child))
        groups.setdefault(shape, []).append(i)

    vmapped = jax.jit(
        jax.vmap(sample_ancestral_states,
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)),
        static_argnums=(11,),
    )

    for (n_internal, n_edges), idxs in groups.items():
        T = len(idxs)
        n_tips = parsed[idxs[0]][1].n_tips
        tip_states = np.zeros((T, n_tips, L), np.int32)
        tip_parent = np.zeros((T, n_tips), np.int32)
        tip_length = np.zeros((T, n_tips))
        edge_child = np.zeros((T, n_edges), np.int32)
        edge_parent = np.zeros((T, n_edges), np.int32)
        edge_length = np.zeros((T, n_edges))
        er = np.zeros((T, 6))
        pi = np.zeros((T, 4))
        rates = np.zeros((T, n_rates))

        for t, i in enumerate(idxs):
            r = boot_rows[i]
            _, arrays, tip_nodes, _ = parsed[i]
            row_seqs = dict(seqs)
            row_seqs["naive"] = r["NaiveSequence"]
            for s_i, lab in enumerate(arrays.tip_labels):
                if lab not in row_seqs:
                    raise ValueError(f"tip {lab!r} missing from {fasta_path}")
                tip_states[t, s_i] = encode(row_seqs[lab])
            tip_parent[t] = arrays.tip_parent
            tip_length[t] = arrays.tip_length
            edge_child[t] = arrays.edge_child
            edge_parent[t] = arrays.edge_parent
            edge_length[t] = arrays.edge_length
            er[t] = [float(r[f"er[{k}]"]) for k in range(1, 7)]
            pi[t] = [float(r[f"pi[{k}]"]) for k in range(1, 5)]
            rates[t] = [float(r[f"sr[{k}]"]) for k in range(1, n_rates + 1)]

        eig = gtr_eigen(er, pi)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, T)
        sample = vmapped(
            keys,
            jax.tree.map(lambda a: jnp.asarray(a, dtype), eig),
            jnp.asarray(pi, dtype), jnp.asarray(rates, dtype),
            jnp.asarray(tip_states), jnp.asarray(tip_parent),
            jnp.asarray(tip_length, dtype), jnp.asarray(edge_child),
            jnp.asarray(edge_parent), jnp.asarray(edge_length, dtype),
            jnp.asarray([n_internal - 1] * T),
            n_internal + 1,
        )
        internal_states = np.asarray(sample.internal_states)

        for t, i in enumerate(idxs):
            root, arrays, tip_nodes, internal_nodes = parsed[i]
            row_seqs = dict(seqs)
            row_seqs["naive"] = boot_rows[i]["NaiveSequence"]
            # Tips keep their observed sequences verbatim (including
            # ambiguous Ns), matching the reference's annotated output.
            for s_i, node in enumerate(tip_nodes):
                node.annotations["ancestral"] = \
                    row_seqs[arrays.tip_labels[s_i]]
            for s_i, node in enumerate(internal_nodes):
                node.annotations["ancestral"] = "".join(
                    alphabet[b] for b in internal_states[t, s_i])
            out[i] = write_annotated_newick(root)
    return out


def main(argv=None) -> int:
    """CLI mirroring the reference R script's positional contract
    (scripts/run_bootstrap_asr_ess.R:2-13):

        input.path fasta.path burnin.frac subsamp.frac num.cores seed
        output.trees.path output.log.path output.ess.path

    num.cores is accepted for compatibility and ignored: the ASR hot loop
    the reference parallelized with R `parallel` runs as one batched
    device computation here.
    """
    import argparse

    p = argparse.ArgumentParser(
        description="Importance-weighted bootstrap + ESS + ancestral "
                    "sequence reconstruction over the pipeline TSV.")
    p.add_argument("input_path", help="lh_revbayes_run.trees TSV")
    p.add_argument("fasta_path", help="clonal family FASTA")
    p.add_argument("burnin_frac", type=float)
    p.add_argument("subsamp_frac", type=float)
    p.add_argument("num_cores", type=int)
    p.add_argument("seed", type=int)
    p.add_argument("output_trees_path")
    p.add_argument("output_log_path")
    p.add_argument("output_ess_path")
    a = p.parse_args(argv)
    run_bootstrap_asr(
        a.input_path, a.fasta_path, a.burnin_frac, a.subsamp_frac, a.seed,
        output_trees_path=a.output_trees_path,
        output_log_path=a.output_log_path,
        output_ess_path=a.output_ess_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
