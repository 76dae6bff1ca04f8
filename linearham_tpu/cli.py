"""Command-line interface.

Mirrors the reference binary's subcommand contract
(src/linearham.cpp:268-455):

  python -m linearham_tpu.cli compute-logl --yaml-path ... --cluster-ind 0
      --hmm-param-dir ... --newick-path ... --er ...x6 --pi ...x4
      [--alpha A] [--num-rates K] [--seed S]
  python -m linearham_tpu.cli sample       (same, plus --N)
  python -m linearham_tpu.cli pipeline --yaml-path ... --cluster-ind 0
      --hmm-param-dir ... --input-path revbayes.trees --output-path out.tsv
      [--num-rates K] [--seed S]
  python -m linearham_tpu.cli warmup   (pipeline args minus --output-path;
      pre-bakes the family/executable caches for the ensemble's shapes)

Both ``--compute-logl`` (reference spelling) and ``compute-logl`` forms are
accepted.
"""

from __future__ import annotations

import argparse
import sys


def _base_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--yaml-path", required=True,
                   help="partis output YAML file")
    p.add_argument("--cluster-ind", type=int, required=True,
                   help="index of the clonal family of interest")
    p.add_argument("--hmm-param-dir", required=True,
                   help="directory of partis HMM germline parameter files")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--num-rates", type=int, default=1,
                   help="number of gamma rate categories")
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto",
                   help="compute precision: f32 (production; on the GPU "
                        "pruning runs the CUDA kernel), f64 (reference-"
                        "conformance numerics); auto = f32 on the GPU, "
                        "f64 on the CPU")


def _phylo_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--newick-path", required=True, help="Newick tree file")
    p.add_argument("--er", type=float, action="append", required=True,
                   help="GTR exchangeability (give 6 times)")
    p.add_argument("--pi", type=float, action="append", required=True,
                   help="GTR stationary probability (give 4 times)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="gamma shape parameter")


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="linearham-tpu",
        description="A JAX phylo-HMM for B cell receptor analysis.",
    )
    sub = top.add_subparsers(dest="subcommand", required=True)

    p = sub.add_parser("compute-logl",
                       help="compute the Phylo-HMM log-likelihood")
    _base_args(p)
    _phylo_args(p)

    p = sub.add_parser("sample", help="sample naive sequences")
    _base_args(p)
    _phylo_args(p)
    p.add_argument("--N", type=int, default=1,
                   help="number of naive sequences to sample")

    p = sub.add_parser("pipeline", help="run the full pipeline")
    _base_args(p)
    p.add_argument("--input-path", required=True,
                   help="RevBayes output TSV file")
    p.add_argument("--output-path", required=True,
                   help="output TSV file")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall-clock timings to stderr")
    p.add_argument("--trace-dir",
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--chunk-size", type=int, default=256,
                   help="trees per fused device step (larger chunks "
                        "amortize dispatch overhead; default 256)")

    p = sub.add_parser(
        "repertoire",
        help="run MANY families' pipelines as one batched device "
             "workload (families are bucketed, padded, stacked, and "
             "vmapped; the fixed per-process cost is paid once instead "
             "of once per family — the fast path for the reference's "
             "default ~1000-tree ensembles)")
    p.add_argument("--families", required=True,
                   help="manifest TSV, one family per line: "
                        "yaml_path<TAB>cluster_ind<TAB>trees_tsv<TAB>"
                        "output_tsv ('#' comments allowed)")
    p.add_argument("--hmm-param-dir", required=True,
                   help="directory of partis HMM germline parameter files")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--num-rates", type=int, default=4,
                   help="number of gamma rate categories")
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall-clock timings to stderr")

    p = sub.add_parser(
        "serve",
        help="long-lived pipeline server: read one JSON request per "
             "stdin line ({yaml_path, cluster_ind, hmm_param_dir, "
             "input_path, output_path, num_rates?, seed?, chunk_size?}) "
             "and run each through the warm process — backend start-up, "
             "cache loads, and compiled executables are paid once, so "
             "reference-default (~1000-tree) ensembles run at the "
             "in-process steady rate")
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto")

    p = sub.add_parser(
        "warmup",
        help="pre-bake the family/executable/compile caches for a "
             "family + ensemble shape, so a later pipeline run starts "
             "warm")
    _base_args(p)
    p.add_argument("--input-path", required=True,
                   help="RevBayes output TSV file (shapes are taken "
                        "from it; only the first chunk is executed)")
    p.add_argument("--chunk-size", type=int, default=256,
                   help="chunk size the later pipeline run will use "
                        "(the compiled-step cache is shape-keyed)")
    return top


def _validate_gtr(args) -> None:
    if len(args.er) != 6:
        raise SystemExit(f"error: --er must be given 6 times, got "
                         f"{len(args.er)}")
    if len(args.pi) != 4:
        raise SystemExit(f"error: --pi must be given 4 times, got "
                         f"{len(args.pi)}")
    if abs(sum(args.pi) - 1.0) > 1e-6:
        print(f"warning: pi sums to {sum(args.pi):g}; it will be used as "
              "given by the normalized GTR model", file=sys.stderr)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Accept the reference's '--compute-logl' style subcommand spelling.
    if argv and argv[0].startswith("--") and argv[0][2:] in (
            "compute-logl", "sample", "pipeline"):
        argv[0] = argv[0][2:]
    args = build_parser().parse_args(argv)

    from linearham_tpu.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu.utils.runtime import enable_persistent_cache, \
        resolve_dtype

    enable_persistent_cache()
    dtype = resolve_dtype(args.precision)

    if args.subcommand == "compute-logl":
        _validate_gtr(args)
        hmm = cached_phylo_hmm(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            seed=args.seed, dtype=dtype)
        hmm.init_phylo_parameters(args.newick_path, args.er, args.pi,
                                  args.alpha, args.num_rates)
        print(f"{hmm.log_likelihood():.6g}")
    elif args.subcommand == "sample":
        _validate_gtr(args)
        hmm = cached_phylo_hmm(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            seed=args.seed, dtype=dtype)
        hmm.init_phylo_parameters(args.newick_path, args.er, args.pi,
                                  args.alpha, args.num_rates)
        for ann in hmm.sample_annotations(args.N):
            print(ann.naive_seq)
    elif args.subcommand == "serve":
        import json
        import time

        from linearham_tpu.pipeline.run import run_pipeline

        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            if line in ("quit", "exit"):
                break
            try:
                req = json.loads(line)
                t0 = time.perf_counter()
                result = run_pipeline(
                    req["yaml_path"], int(req["cluster_ind"]),
                    req["hmm_param_dir"], req["input_path"],
                    req["output_path"],
                    num_rates=int(req.get("num_rates", 4)),
                    seed=int(req.get("seed", 0)),
                    chunk_size=int(req.get("chunk_size", 256)),
                    precision=req.get("precision", args.precision),
                )
                print(json.dumps({
                    "ok": True,
                    "output_path": req["output_path"],
                    "n_trees": result.samples.n_samples,
                    "wall_s": round(time.perf_counter() - t0, 3),
                }), flush=True)
            except Exception as exc:  # keep serving after a bad request
                print(json.dumps({"ok": False, "error": str(exc)}),
                      flush=True)
    elif args.subcommand == "repertoire":
        import time

        from linearham_tpu.io.trees_tsv import load_tree_samples
        from linearham_tpu.parallel.repertoire import (FamilyTask,
                                                       run_repertoire,
                                                       write_family_output)

        t0 = time.perf_counter()
        rows = []
        with open(args.families) as fh:
            for ln in fh:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                parts = ln.split("\t")
                if len(parts) != 4:
                    raise SystemExit(
                        f"error: manifest line needs 4 tab-separated "
                        f"fields (yaml, cluster_ind, trees, out): {ln!r}")
                rows.append((parts[0], int(parts[1]), parts[2], parts[3]))
        if not rows:
            raise SystemExit("error: empty family manifest")
        tasks = [
            FamilyTask(
                hmm=cached_phylo_hmm(yaml, ci, args.hmm_param_dir,
                                     seed=args.seed, dtype=dtype,
                                     place=False),
                samples=load_tree_samples(trees))
            for yaml, ci, trees, _ in rows
        ]
        timings: dict = {}
        results = run_repertoire(tasks, num_rates=args.num_rates,
                                 seed=args.seed, dtype=dtype,
                                 timings=timings)
        for (_, _, _, out_path), task, res in zip(rows, tasks, results):
            write_family_output(task, res, args.num_rates, out_path)
        wall = time.perf_counter() - t0
        total = sum(t.samples.n_samples for t in tasks)
        if args.profile:
            for k, v in timings.items():
                print(f"#   {k}: {v * 1e3:.1f}ms", file=sys.stderr)
        print(f"repertoire ok: {len(tasks)} families, {total} trees in "
              f"{wall:.2f}s ({total / wall:.1f} trees/s aggregate)")
    elif args.subcommand == "warmup":
        import threading
        import time

        import numpy as np

        from linearham_tpu.io.trees_tsv import load_tree_samples
        from linearham_tpu.pipeline.run import run_pipeline_arrays

        t0 = time.perf_counter()

        # Same backend start-up overlap as run_pipeline: it hides behind
        # the host-side loads.
        def _dial():
            try:
                import jax

                jax.block_until_ready(
                    jax.device_put(np.zeros(8, np.float32)))
            except Exception:
                pass

        threading.Thread(target=_dial, daemon=True).start()
        samples = load_tree_samples(args.input_path)
        hmm = cached_phylo_hmm(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            seed=args.seed, dtype=dtype, place=False)
        # One chunk through the real step: shapes are pinned from the
        # WHOLE ensemble (max_chunks only limits execution), so the
        # compiled/cached executable exactly matches a full run, and
        # every cache is left populated.
        result = run_pipeline_arrays(hmm, samples, args.num_rates,
                                     seed=args.seed,
                                     chunk_size=args.chunk_size,
                                     max_chunks=1)
        n = len(result.annotations)
        expected = min(args.chunk_size, samples.n_samples)
        if n != expected:
            raise RuntimeError(
                f"warmup drained {n} trees, expected {expected}")
        # The exec-cache persist runs on a daemon thread; this process
        # exists to leave caches populated, so join it before declaring
        # success (a serialize killed at interpreter exit would leave the
        # exec cache silently cold).
        from linearham_tpu.utils.exec_cache import flush

        if not flush(timeout=300.0):
            raise RuntimeError(
                "warmup: executable serialization did not finish")
        print(f"warmup ok: family + step caches populated for "
              f"chunk={args.chunk_size} in "
              f"{time.perf_counter() - t0:.1f}s "
              f"({n} trees exercised)")
    else:
        from linearham_tpu.pipeline.run import run_pipeline

        run_pipeline(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            args.input_path, args.output_path, args.num_rates,
            seed=args.seed, chunk_size=args.chunk_size,
            profile=args.profile, trace_dir=args.trace_dir,
            precision=args.precision,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
