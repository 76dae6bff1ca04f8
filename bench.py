#!/usr/bin/env python3
"""Headline benchmark: posterior-tree pipeline throughput per chip.

Modes (BENCH_MODE):
  pipeline         (default) the full production unit, matching the
                   reference's --pipeline invocation
                   (src/PhyloHMM.cpp:393-446): partis YAML + RevBayes TSV
                   in -> per-tree loglik/sample/annotation -> output TSV,
                   including host parse/decode/write.
  step             the fused device step alone: Felsenstein pruning over
                   the xMSA x 4 gamma rates + HMM forward + FFBS, batched
                   over trees.
  repertoire       the full per-family repertoire unit: per-family
                   YAML+TSV in -> bucket stack -> stacked device step ->
                   per-family decode -> per-family output TSVs.
  repertoire_step  the stacked multi-family DEVICE step alone.

The BASELINE.md target is >=1000 trees/sec/chip.  The requested mode runs
once, in this process, on the GPU: the bench refuses to run without one.
Prints the card's name, power limit and count on stderr, then ONE JSON
line with at least {"metric", "value", "unit", "vs_baseline", "device"};
extra keys (compile_s, stages, ...) carry the stage breakdown.
"""

import json
import os
import sys
import time

BASELINE_TREES_PER_SEC = 1000.0


def _emit(result: dict) -> None:
    import jax

    d = jax.devices()[0]
    result["device"] = {"platform": d.platform, "kind": d.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(result))


def _flush_transfers(tree) -> float:
    """Force all pending host->device transfers in a pytree to complete
    (one tiny jitted reduce + one scalar read).  Returns elapsed seconds."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    leaves = [l for l in jax.tree.leaves(tree)
              if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.number)]
    total = jax.jit(
        lambda ls: sum(l.astype(jnp.float32).sum() for l in ls))(leaves)
    float(total)
    return time.perf_counter() - t0


def step_mode() -> int:
    """The fused device step: trees/s for one [T]-tree batched dispatch."""
    n_trees = int(os.environ.get("BENCH_TREES", "4096"))
    n_seqs = int(os.environ.get("BENCH_SEQS", "10"))
    reps = int(os.environ.get("BENCH_REPS", "5"))

    import jax
    import jax.numpy as jnp

    from linearham_tpu.models.phylo_hmm import PhyloHMM, phylo_step_jit
    from linearham_tpu.pipeline.run import prepare_ensemble
    from linearham_tpu.utils.synth import make_family, make_tree_samples

    dtype = jnp.float32
    fam = make_family(n_seqs=n_seqs, seed=0)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=dtype,
    )
    samples = make_tree_samples(fam, n_trees, seed=0)

    t0 = time.perf_counter()
    tree_arrays, eig, rates, n_slots = prepare_ensemble(hmm, samples, 4)
    host_prep_s = time.perf_counter() - t0

    def to_dev(a):
        import numpy as np
        a = np.asarray(a)
        return jnp.asarray(a, dtype) if np.issubdtype(a.dtype, np.floating) \
            else jnp.asarray(a)

    tree_dev = {k: to_dev(v) for k, v in tree_arrays.items()}
    eig_dev = jax.tree.map(to_dev, eig)
    pi_dev, rates_dev = to_dev(samples.pi), to_dev(rates)

    # Dispatch K steps back-to-back (async) and amortize ONE host read
    # over them: the device runs programs in order, so syncing on the
    # last step's output proves all K ran.
    K = int(os.environ.get("BENCH_CHAIN", "16"))

    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, K)
    # Flush the host->device input transfers before the compile timer so
    # compile_s measures compilation, not input staging.
    transfer_s = _flush_transfers(
        (hmm._trans, hmm._consts, hmm._xmsa_rows, hmm._naive_bases,
         tree_dev, eig_dev, pi_dev, rates_dev))
    # Compile via the ordinary jit call path: AOT .lower().compile()
    # BYPASSES the persistent compilation cache (measured: warm 40.8s ==
    # cold 40.3s via AOT, vs 18.6s -> 8.7s cross-process through the jit
    # path), so a jit call is the only measurement that shows the
    # cache working.
    def step(subkey):
        return phylo_step_jit(
            hmm._trans, hmm._consts, hmm._xmsa_rows, hmm._naive_bases,
            tree_dev, eig_dev, pi_dev, rates_dev, subkey,
            heavy=True, n_slots=n_slots,
        )

    t0 = time.perf_counter()
    loglik, _, path = step(keys[0])
    float(loglik.sum() + path.jgerm_idx.sum())  # host read = true sync
    compile_s = time.perf_counter() - t0

    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        for k in range(K):
            loglik, _, path = step(keys[k])
        float(loglik.sum() + path.jgerm_idx.sum())
        times.append((time.perf_counter() - t0) / K)

    times.sort()
    median = times[len(times) // 2]
    trees_per_sec = n_trees / median
    _emit({
        "metric": "posterior_tree_pipeline_steps_per_sec_per_chip",
        "value": round(trees_per_sec, 1),
        "unit": "trees/s",
        "vs_baseline": round(trees_per_sec / BASELINE_TREES_PER_SEC, 3),
        "compile_s": round(compile_s, 2),
    })
    print(
        f"# n_trees={n_trees} n_seqs={n_seqs} sites={fam.n_sites} "
        f"xmsa_cols={hmm.xmsa.n_cols} chain={K} median={median * 1e3:.2f}ms "
        f"times_ms={[round(t * 1e3, 3) for t in times]} "
        f"compile={compile_s:.1f}s transfer={transfer_s:.1f}s "
        f"host_prep={host_prep_s:.2f}s "
        f"device={jax.devices()[0].device_kind} "
        f"mean_loglik={float(loglik.mean()):.2f}",
        file=sys.stderr,
    )
    return 0


def pipeline_mode() -> int:
    """BENCH_MODE=pipeline: the whole production invocation, file to file.

    Measures what the reference's `linearham --pipeline` does end to end:
    read the partis YAML + RevBayes trees TSV, compute per-tree
    log-likelihoods, sample one annotation per tree, decode to naive
    sequences/VDJ fields, and write the output TSV.  Synthetic input
    files are generated OUTSIDE the timed region (they stand in for
    partis/RevBayes artifacts that already exist on disk in production).
    """
    import tempfile

    n_trees = int(os.environ.get("BENCH_TREES", "10240"))
    n_seqs = int(os.environ.get("BENCH_SEQS", "100"))
    chunk = int(os.environ.get("BENCH_CHUNK", "4096"))

    from linearham_tpu.io.germline import write_gene_dir
    from linearham_tpu.pipeline.run import run_pipeline
    from linearham_tpu.utils.synth import (make_family, make_light_family,
                                           make_tree_samples,
                                           write_partis_yaml,
                                           write_trees_tsv)

    # BENCH_LOCUS=igk exercises the 5-region light-chain path (V-J, no D)
    # at the same ensemble scale.
    locus = os.environ.get("BENCH_LOCUS", "igh")
    with tempfile.TemporaryDirectory() as tmp:
        fam = make_light_family(n_seqs=n_seqs, seed=0) \
            if locus != "igh" else make_family(n_seqs=n_seqs, seed=0)
        gene_dir = os.path.join(tmp, "hmm_params")
        write_gene_dir(fam.genes, gene_dir)
        yaml_path = os.path.join(tmp, "partis_run.yaml")
        write_partis_yaml(fam, yaml_path, seed=0)
        trees_path = os.path.join(tmp, "revbayes_run.trees")
        samples = make_tree_samples(fam, n_trees, seed=0)
        write_trees_tsv(samples, trees_path)
        out_tsv = os.path.join(tmp, "lh_revbayes_run.trees")

        t0 = time.perf_counter()
        result = run_pipeline(
            yaml_path, 0, gene_dir, trees_path, out_tsv, num_rates=4,
            seed=0, chunk_size=chunk,
        )
        wall = time.perf_counter() - t0
        n_rows = sum(1 for _ in open(out_tsv)) - 1

    assert n_rows == n_trees, (n_rows, n_trees)
    stages = {k: round(v, 3) for k, v in (result.timings or {}).items()}
    compile_s = stages.get("compile_and_first_step", 0.0)
    device_s = stages.get("device_step", 0.0) + compile_s
    trees_per_sec = n_trees / wall
    # Device-only throughput over the steady-state chunks (the first
    # chunk is inside compile_and_first_step).
    steady_trees = max(0, n_trees - chunk)
    dev_tps = round(steady_trees / stages["device_step"], 1) \
        if stages.get("device_step") and steady_trees else None
    _emit({
        "metric": "pipeline_end_to_end_trees_per_sec_per_chip",
        "value": round(trees_per_sec, 1),
        "unit": "trees/s",
        "vs_baseline": round(trees_per_sec / BASELINE_TREES_PER_SEC, 3),
        "compile_s": round(compile_s, 2),
        "stages": stages,
        "device_frac": round(device_s / wall, 3) if wall else None,
        "device_trees_per_sec": dev_tps,
        "n_trees": n_trees,
        "n_seqs": n_seqs,
    })
    from linearham_tpu.utils.runtime import resolve_dtype, use_pruning_kernel

    dtype = resolve_dtype(None)
    print(f"# pipeline n_trees={n_trees} n_seqs={n_seqs} chunk={chunk} "
          f"wall={wall:.2f}s stages={stages} dtype={dtype.__name__} "
          f"pruning_kernel={use_pruning_kernel(dtype)}", file=sys.stderr)
    return 0


def repertoire_mode() -> int:
    """BENCH_MODE=repertoire: the full per-family repertoire unit.

    File to file for EVERY family, like pipeline mode but multi-family:
    per-family partis YAML + RevBayes TSV in -> bucket stack -> one
    stacked device step -> per-family decode -> per-family output TSV.
    Input files are generated untimed (they stand in for partis/RevBayes
    artifacts that exist on disk in production).  Reports the
    pipeline-mode stage breakdown including the host decode share
    (VERDICT r03 item 4).
    """
    import tempfile

    import numpy as np

    n_fams = int(os.environ.get("BENCH_FAMS", "32"))
    n_trees = int(os.environ.get("BENCH_TREES", "320"))

    import jax
    import jax.numpy as jnp

    from linearham_tpu.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu.io.germline import write_gene_dir
    from linearham_tpu.io.trees_tsv import load_tree_samples
    from linearham_tpu.parallel.repertoire import (FamilyTask,
                                                   run_repertoire,
                                                   write_family_output)
    from linearham_tpu.utils.runtime import resolve_dtype
    from linearham_tpu.utils.synth import (make_family, make_tree_samples,
                                           write_partis_yaml,
                                           write_trees_tsv)

    dtype = resolve_dtype(None)
    with tempfile.TemporaryDirectory() as tmp:
        # Untimed input generation.  One shared gene dir; family structure
        # is bucket-identical (seed 0: stacked execution runs one bucket,
        # the production fast path) while every family's posterior tree
        # ensemble differs.
        fam = make_family(n_seqs=int(os.environ.get("BENCH_SEQS", "10")),
                          seed=0)
        gene_dir = os.path.join(tmp, "hmm_params")
        write_gene_dir(fam.genes, gene_dir)
        yaml_path = os.path.join(tmp, "partis_run.yaml")
        write_partis_yaml(fam, yaml_path, seed=0)
        tsv_paths = []
        for f in range(n_fams):
            p = os.path.join(tmp, f"fam{f:04d}.trees")
            write_trees_tsv(make_tree_samples(fam, n_trees, seed=f), p)
            tsv_paths.append(p)

        stages = {}
        t_wall = time.perf_counter()
        t0 = time.perf_counter()
        # place=False: repertoire stacking reads host copies only; the
        # per-family device placement would ship ~3MB x n_fams for nothing.
        hmms = [cached_phylo_hmm(yaml_path, 0, gene_dir, seed=0,
                                 dtype=dtype, place=False)
                for _ in range(n_fams)]
        stages["build_hmm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tasks = [FamilyTask(hmm=h, samples=load_tree_samples(p))
                 for h, p in zip(hmms, tsv_paths)]
        stages["load_trees_tsv"] = time.perf_counter() - t0
        results = run_repertoire(tasks, num_rates=4, seed=0, dtype=dtype,
                                 timings=stages)
        t0 = time.perf_counter()
        for f, (task, res) in enumerate(zip(tasks, results)):
            write_family_output(task, res, 4,
                                os.path.join(tmp, f"lh_fam{f:04d}.trees"))
        stages["write_tsv"] = time.perf_counter() - t0
        wall = time.perf_counter() - t_wall

        n_rows = sum(
            sum(1 for _ in open(os.path.join(tmp, f"lh_fam{f:04d}.trees")))
            - 1 for f in range(n_fams))
    total_trees = n_fams * n_trees
    assert n_rows == total_trees, (n_rows, total_trees)
    tps = total_trees / wall
    stages = {k: round(v, 3) for k, v in stages.items()}
    _emit({
        "metric": "repertoire_end_to_end_trees_per_sec_per_chip",
        "value": round(tps, 1),
        "unit": "trees/s",
        "vs_baseline": round(tps / BASELINE_TREES_PER_SEC, 3),
        # no compile_s: the single stacked dispatch cannot split compile
        # from execution; device_step in stages carries the total.
        "stages": stages,
        "decode_frac": round(stages.get("decode", 0.0) / wall, 3),
        "n_fams": n_fams,
        "n_trees_per_fam": n_trees,
    })
    print(f"# repertoire-e2e fams={n_fams} trees/fam={n_trees} "
          f"wall={wall:.2f}s stages={stages}", file=sys.stderr)
    return 0


def repertoire_step_mode() -> int:
    """BENCH_MODE=repertoire_step: stacked multi-family DEVICE step only.

    F identically-shaped synthetic families stack on a leading axis and run
    through the same vmapped fused step the (fam, trees) mesh shards across
    chips -- on one chip this measures the repertoire-scale execution path
    (bucketed stacking + vmap of the pruning kernel).
    """
    n_fams = int(os.environ.get("BENCH_FAMS", "8"))
    n_trees = int(os.environ.get("BENCH_TREES", "256"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    K = int(os.environ.get("BENCH_CHAIN", "8"))

    import functools

    import jax
    import jax.numpy as jnp

    from linearham_tpu.parallel.mesh import multi_family_step

    import __graft_entry__ as graft

    import numpy as np

    per_family = []
    n_slots = None
    for f in range(n_fams):
        # Family seed stays 0 so shapes match across the stack (bucketed
        # execution requires it); the posterior ensembles vary per family.
        _, args, n_slots = graft._build_family_inputs(
            jnp.float32, n_trees=n_trees, seed=0, tree_seed=f,
            as_numpy=True)
        per_family.append(args)
    # Stack on host, land with ONE batched put.
    stacked = jax.device_put(
        jax.tree.map(lambda *xs: np.stack(xs), *per_family))
    trans, consts, rows, naive, tree, eig, pi, rates, keys = stacked

    step = jax.jit(functools.partial(
        multi_family_step, heavy=True, n_slots=n_slots))

    # Same K-dispatch / one-host-read sync pattern as step_mode.
    _flush_transfers(stacked)
    t0 = time.perf_counter()
    loglik, path = step(trans, consts, rows, naive, tree, eig, pi, rates,
                        keys)
    float(loglik.sum() + path.jgerm_idx.sum())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(K):
            loglik, path = step(trans, consts, rows, naive, tree, eig, pi,
                                rates, keys)
        float(loglik.sum() + path.jgerm_idx.sum())
        times.append((time.perf_counter() - t0) / K)
    times.sort()
    median = times[len(times) // 2]
    total_trees = n_fams * n_trees
    _emit({
        "metric": "repertoire_trees_per_sec_per_chip",
        "value": round(total_trees / median, 1),
        "unit": "trees/s",
        "vs_baseline": round(total_trees / median / BASELINE_TREES_PER_SEC, 3),
        "compile_s": round(compile_s, 2),
    })
    print(f"# fams={n_fams} trees/fam={n_trees} chain={K} "
          f"median={median * 1e3:.2f}ms compile={compile_s:.1f}s",
          file=sys.stderr)
    return 0


def _enable_cache() -> None:
    from linearham_tpu.utils.runtime import enable_persistent_cache

    enable_persistent_cache()


def main() -> int:
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: bench.py measures the GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"# {len(jax.devices())} x {card.stdout.strip().splitlines()[0]}",
          file=sys.stderr)
    _enable_cache()
    # The DEFAULT measurement is the full production unit (pipeline mode):
    # it is what the reference's --pipeline invocation does, host work and
    # all.  BENCH_MODE=step isolates the fused device step.
    mode = os.environ.get("BENCH_MODE", "pipeline")
    modes = {"pipeline": pipeline_mode, "step": step_mode,
             "repertoire": repertoire_mode,
             "repertoire_step": repertoire_step_mode}
    if mode not in modes:
        print(f"error: unknown BENCH_MODE {mode!r} "
              f"(one of {', '.join(modes)})", file=sys.stderr)
        return 2
    return modes[mode]()


if __name__ == "__main__":
    sys.exit(main())
