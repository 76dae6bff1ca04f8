#!/usr/bin/env python3
"""Proof that linearham_tpu runs on an NVIDIA GPU, through its entry points.

    python chip_smoke.py               # one card, phases (a)-(e) below
    python chip_smoke.py --four-cards  # the sharded repertoire on four cards

One card:
  (e) the tests marked ``gpu``, in a child process started before this
      process touches the card (a JAX process reserves most of its memory);
  (a) JAX's first device must be a GPU; there is no fallback to the CPU;
  (b) the pruning kernel compiled for the card, and the fused step's
      ``memory_analysis()`` at the official chunk;
  (c) the official unit through the CLI's ``pipeline`` entry: igh, 100
      sequences, 10,240 trees, 4 rates, chunk 4096, auto precision;
  (d) the ``repertoire`` entry, 8 families x 320 trees (the vmapped kernel);
  then, with float64 enabled (it is process-global, so last):
  (c') the first 256 trees of (c) again in f64, per-tree |d loglik| <= 0.05;
  (b') the kernel against the f64 jnp reference on the card at the 100-seq
      (863 xMSA columns) and 312-seq (1009 columns) families: per site
      |d| < 2e-3, per tree summed |d| < 0.05 (tests/test_precision.py).
Four cards: only ``__graft_entry__.dryrun_multichip(4)`` — 8 families of 100
sequences x 1024 trees on a (fam=4, trees=1) mesh against one card.

Inputs are synthesized from fixed seeds.  Any failed phase raises, and the
script exits non-zero; it also exits non-zero, printing no result, when no
GPU is found or the repository is not beside it.  The last line of
standard output is the JSON result; the line before it is the card's name
and power limit as nvidia-smi reports them.  Honors
JAX_COMPILATION_CACHE_DIR.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SITE_ATOL = 2e-3          # per-site |d log-lik|, kernel vs f64 reference
TREE_SUM_ATOL = 0.05      # per-tree summed |d| of the same
PIPELINE_ATOL = 0.05      # per-tree pipeline |d loglik|, f32 vs f64
OFFICIAL = dict(n_seqs=100, n_trees=10240, rates=4, chunk=4096)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()


def phase_gpu_tests() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    log(f"phase e: gpu-marked tests: {summary} "
        f"({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or "passed" not in summary \
            or "skipped" in summary:
        sys.stderr.write(proc.stdout[-8000:] + proc.stderr[-4000:])
        raise RuntimeError("gpu-marked tests did not all pass")


def write_inputs(tmp: str, fam, samples):
    from linearham_tpu.io.germline import write_gene_dir
    from linearham_tpu.utils.synth import write_partis_yaml, write_trees_tsv

    gene_dir = os.path.join(tmp, "hmm_params")
    write_gene_dir(fam.genes, gene_dir)
    yaml_path = os.path.join(tmp, "partis_run.yaml")
    write_partis_yaml(fam, yaml_path, seed=0)
    trees = os.path.join(tmp, "revbayes_run.trees")
    write_trees_tsv(samples, trees)
    return gene_dir, yaml_path, trees


def read_logliks(path: str):
    import numpy as np

    with open(path) as fh:
        rows = list(csv.DictReader(fh, delimiter="\t"))
    return np.asarray([float(r["LHLogLikelihood"]) for r in rows])


def subset(samples, n: int):
    from linearham_tpu.io.trees_tsv import TreeSamples

    return TreeSamples(
        iteration=samples.iteration[:n], rb_loglik=samples.rb_loglik[:n],
        prior=samples.prior[:n], alpha=samples.alpha[:n],
        er=samples.er[:n], pi=samples.pi[:n], newicks=samples.newicks[:n])


def phase_fused_step_memory(fam, samples) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from linearham_tpu.models.phylo_hmm import (PhyloHMM,
                                                phylo_step_packed_jit)
    from linearham_tpu.ops import pruning_kernel
    from linearham_tpu.pipeline.run import prepare_ensemble

    t0 = time.perf_counter()
    pruning_kernel.register()
    log(f"phase b: kernel library built and registered "
        f"({time.perf_counter() - t0:.1f} s)")
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32)
    chunk = subset(samples, OFFICIAL["chunk"])
    tree, eig, rates, n_slots = prepare_ensemble(hmm, chunk,
                                                 OFFICIAL["rates"])
    assert "sched_src" in tree, "the GPU policy must select the kernel"
    f32 = lambda a: np.asarray(a, np.float32)            # noqa: E731
    tree = {k: (f32(v) if np.issubdtype(np.asarray(v).dtype, np.floating)
                else np.asarray(v)) for k, v in tree.items()}
    t0 = time.perf_counter()
    compiled = phylo_step_packed_jit.lower(
        hmm._trans, hmm._consts, hmm._xmsa_rows, hmm._naive_bases, tree,
        jax.tree.map(f32, eig), f32(chunk.pi), f32(rates),
        jax.random.PRNGKey(0), heavy=True, n_slots=n_slots).compile()
    log(f"phase b: fused step compiled at chunk {OFFICIAL['chunk']} "
        f"({time.perf_counter() - t0:.1f} s); memory_analysis: "
        f"{compiled.memory_analysis()}")


def phase_pipeline(tmp, gene_dir, yaml_path, trees, precision, n_expect,
                   chunk, tag):
    import numpy as np

    from linearham_tpu import cli

    out = os.path.join(tmp, f"lh_{tag}.trees")
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", "--yaml-path", yaml_path, "--cluster-ind",
                   "0", "--hmm-param-dir", gene_dir, "--input-path", trees,
                   "--output-path", out, "--num-rates",
                   str(OFFICIAL["rates"]), "--seed", "0", "--chunk-size",
                   str(chunk), "--precision", precision])
    wall = time.perf_counter() - t0
    ll = read_logliks(out)
    if rc != 0 or len(ll) != n_expect or not np.isfinite(ll).all():
        raise RuntimeError(
            f"pipeline {tag}: rc={rc} rows={len(ll)} (want {n_expect}) "
            f"finite={bool(np.isfinite(ll).all())}")
    log(f"phase {tag}: pipeline entry, {len(ll)} rows, all finite, "
        f"precision {precision}, chunk {chunk}, wall {wall:.2f} s "
        f"(compile included), mean loglik {ll.mean():.4f}")
    return ll


def phase_repertoire(tmp, fam, gene_dir, yaml_path) -> None:
    import numpy as np

    from linearham_tpu import cli
    from linearham_tpu.utils.synth import make_tree_samples, write_trees_tsv

    n_fams, n_trees = 8, 320
    manifest = os.path.join(tmp, "families.tsv")
    outs = []
    with open(manifest, "w") as fh:
        for f in range(n_fams):
            trees = os.path.join(tmp, f"fam{f}.trees")
            write_trees_tsv(make_tree_samples(fam, n_trees, seed=100 + f),
                            trees)
            outs.append(os.path.join(tmp, f"lh_fam{f}.trees"))
            fh.write(f"{yaml_path}\t0\t{trees}\t{outs[-1]}\n")
    t0 = time.perf_counter()
    rc = cli.main(["repertoire", "--families", manifest, "--hmm-param-dir",
                   gene_dir, "--num-rates", str(OFFICIAL["rates"]),
                   "--seed", "0"])
    wall = time.perf_counter() - t0
    for path in outs:
        ll = read_logliks(path)
        if rc != 0 or len(ll) != n_trees or not np.isfinite(ll).all():
            raise RuntimeError(f"repertoire output {path}: rc={rc} "
                               f"rows={len(ll)}")
    log(f"phase d: repertoire entry, {n_fams} families x {n_trees} trees, "
        f"all rows finite, wall {wall:.2f} s (compile included)")


def phase_kernel_vs_reference() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from linearham_tpu.io.native import parse_newicks_batch
    from linearham_tpu.io.schedule import build_schedule
    from linearham_tpu.models.phylo_hmm import PhyloHMM, site_logliks
    from linearham_tpu.ops.gtr import gamma_category_rates_batch, gtr_eigen
    from linearham_tpu.utils.synth import (CI_DEPTH_FAMILY, make_family,
                                           make_tree_samples)

    run = jax.jit(site_logliks, static_argnames="n_slots")

    def cast(tree, dt):
        return jax.tree.map(
            lambda a: jnp.asarray(a, dt) if np.issubdtype(
                np.asarray(a).dtype, np.floating) else jnp.asarray(a), tree)

    for name, kw, T in (("100-seq", dict(n_seqs=100, seed=0), 256),
                        ("312-seq", CI_DEPTH_FAMILY, 64)):
        fam = make_family(**kw)
        hmm = PhyloHMM.from_parts(
            fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
            fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float64)
        s = make_tree_samples(fam, T, seed=1)
        tb = parse_newicks_batch(s.newicks, hmm.xmsa.labels)
        ref_tree = {"tip_perm": tb.tip_perm, "tip_parent": tb.tip_parent,
                    "tip_length": tb.tip_length, "edge_child": tb.edge_child,
                    "edge_parent": tb.edge_parent,
                    "edge_length": tb.edge_length, "root_slot": tb.root_slot}
        sc = build_schedule(tb)
        k_tree = {"sched_src": sc.src, "sched_penc": sc.penc,
                  "sched_len": sc.length, "sched_root": sc.root}
        eig, pi = gtr_eigen(s.er, s.pi), s.pi
        rates = gamma_category_rates_batch(s.alpha, OFFICIAL["rates"])
        rows = jnp.asarray(hmm._xmsa_rows_np)
        want = np.asarray(run(rows, cast(ref_tree, jnp.float64),
                              cast(eig, jnp.float64), cast(pi, jnp.float64),
                              cast(rates, jnp.float64), n_slots=tb.n_slots))
        got = np.asarray(run(rows, cast(k_tree, jnp.float32),
                             cast(eig, jnp.float32), cast(pi, jnp.float32),
                             cast(rates, jnp.float32), n_slots=sc.n_slots))
        d = got.astype(np.float64) - want
        site, tree_sum = float(np.abs(d).max()), float(
            np.abs(d.sum(axis=1)).max())
        log(f"phase b': kernel vs f64 reference, {name} family, "
            f"{rows.shape[1]} xMSA columns, {T} trees, {sc.n_slots} slots: "
            f"max per-site |d| {site:.3e} (bound {SITE_ATOL}), max per-tree "
            f"summed |d| {tree_sum:.3e} (bound {TREE_SUM_ATOL})")
        if not (np.isfinite(got).all() and site < SITE_ATOL
                and tree_sum < TREE_SUM_ATOL):
            raise RuntimeError(f"kernel outside bounds on the {name} family")


def one_card() -> dict:
    import jax
    import numpy as np

    from linearham_tpu.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=OFFICIAL["n_seqs"], seed=0)
    samples = make_tree_samples(fam, OFFICIAL["n_trees"], seed=0)
    phase_fused_step_memory(fam, samples)
    with tempfile.TemporaryDirectory() as tmp:
        gene_dir, yaml_path, trees = write_inputs(tmp, fam, samples)
        ll32 = phase_pipeline(tmp, gene_dir, yaml_path, trees, "auto",
                              OFFICIAL["n_trees"], OFFICIAL["chunk"], "c")
        phase_repertoire(tmp, fam, gene_dir, yaml_path)

        from linearham_tpu.utils.synth import write_trees_tsv

        head = os.path.join(tmp, "head.trees")
        write_trees_tsv(subset(samples, 256), head)
        ll64 = phase_pipeline(tmp, gene_dir, yaml_path, head, "f64", 256,
                              256, "c'")
    diff = float(np.abs(ll32[:256] - ll64).max())
    log(f"phase c': f32 vs f64 per-tree pipeline loglik, max |d| {diff:.3e} "
        f"(bound {PIPELINE_ATOL})")
    if not diff <= PIPELINE_ATOL:
        raise RuntimeError("f32 pipeline log-likelihoods outside the bound")
    phase_kernel_vs_reference()
    return {"devices": len(jax.devices())}


def four_cards() -> dict:
    import __graft_entry__

    t0 = time.perf_counter()
    summary = __graft_entry__.dryrun_multichip(4)
    log(f"four cards: sharded repertoire matches one card "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(summary)}")
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded repertoire on four cards "
                         "and its one-card comparison")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "linearham_tpu")):
        print("error: chip_smoke.py must sit in a linearham_tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    cards = card_lines()
    if not args.four_cards:
        phase_gpu_tests()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    count = len(jax.devices())
    log(f"phase a: {count} x {dev.device_kind} ({dev.platform}), "
        f"jax {jax.__version__}")
    if args.four_cards:
        if count < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found {count}")
        four_cards()
    else:
        one_card()
    for line in cards[:count]:
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
