"""The batched posterior-ensemble pipeline.

The reference walks the RevBayes TSV one tree at a time, rebuilding a libpll
partition per row (src/PhyloHMM.cpp:393-446).  Here the ensemble runs as a
software pipeline over fixed-shape chunks: each chunk is ONE jitted device
computation (pruning + forward + FFBS for every tree at once), while the
host concurrently parses/stages the next chunk, decodes the previous
chunk's annotations, and streams rows to the output TSV.

Output columns match the reference contract exactly
(src/PhyloHMM.cpp:244-327).
"""

from __future__ import annotations


import re
from dataclasses import dataclass
from typing import List, Optional, TextIO

import jax
import jax.numpy as jnp
import numpy as np

from linearham_tpu.io.newick import batch_trees, parse_newick
from linearham_tpu.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu.models.decode import Annotation
from linearham_tpu.models.phylo_hmm import (PhyloHMM, phylo_step_packed_jit,
                                            unpack_path)
from linearham_tpu.ops.gtr import gamma_category_rates_batch, gtr_eigen

_COMMENT_RE = re.compile(r"\[[^\]]*\]")


@dataclass
class PipelineResult:
    """Per-sample pipeline outputs for one clonal family."""

    samples: TreeSamples
    rates: np.ndarray            # [T, R]
    lh_loglik: np.ndarray        # [T]
    logweight: np.ndarray        # [T]
    annotations: List[Annotation]
    timings: Optional[dict] = None  # stage -> seconds




def prepare_ensemble(hmm: PhyloHMM, samples: TreeSamples, num_rates: int):
    """Host-side ensemble prep: parse/batch trees, gamma rates, GTR eigen.

    Returns (tree_arrays dict, eig (numpy GTREigen), rates [T,R], n_slots).
    Tree parsing uses the native C++ batch parser when available, and the
    arrays use the encoding phylo_step's pruning backend will consume
    (slot-reuse schedule for the GPU kernel, TreeBatch arrays for the
    jnp path; see models.phylo_hmm.ensemble_encoding).
    """
    from linearham_tpu.io.native import parse_newicks_batch
    from linearham_tpu.models.phylo_hmm import ensemble_encoding

    tb = parse_newicks_batch(samples.newicks, hmm.xmsa.labels)
    if tb is None:
        trees = [parse_newick(nw) for nw in samples.newicks]
        tb = batch_trees(trees, hmm.xmsa.labels)
    rates = gamma_category_rates_batch(samples.alpha, num_rates)
    tree_arrays, n_slots = ensemble_encoding(tb, hmm._dtype)
    eig = gtr_eigen(samples.er, samples.pi)  # host numpy factors
    return tree_arrays, eig, rates, n_slots


def _drain_chunk(hmm, timer, logliks, paths, start, n_valid, packed_c,
                 on_chunk=None) -> None:
    """Block on one chunk's device outputs and decode its annotations.

    Log-likelihoods and sampled paths arrive as ONE packed int array
    (int16 normally; a single host read per chunk; see
    phylo_step_packed / unpack_path)."""
    with timer.stage("device_step"):
        packed_np = np.asarray(packed_c)   # blocks until the step is done
    with timer.stage("decode"):
        loglik_np, path_np = unpack_path(
            packed_np[:n_valid], hmm.space.is_heavy,
            hmm.space.vd_junction.n_rows,
            f64=hmm._dtype == jnp.float64)
        logliks[start:start + n_valid] = loglik_np
        anns = hmm._decode_batch(path_np)
        paths.extend(anns)
    if on_chunk is not None:
        on_chunk(start, n_valid, loglik_np, anns)


def run_pipeline_arrays(
    hmm: PhyloHMM,
    samples: TreeSamples,
    num_rates: int,
    seed: int = 0,
    chunk_size: int = 256,
    trace_dir: Optional[str] = None,
    on_chunk=None,
    rates: Optional[np.ndarray] = None,
    max_chunks: Optional[int] = None,
) -> PipelineResult:
    """Run the full ensemble through the fused device step.

    ``on_chunk(start, n_valid, logliks, annotations)`` (optional) fires
    as each chunk drains, enabling streamed output writing that overlaps
    the remaining device work.  ``max_chunks`` stops after that many
    dispatched chunks (the warmup path: shapes are still pinned from the
    WHOLE ensemble, so the compiled/cached step matches a full run);
    results then cover only the executed rows.

    Host work is streamed per chunk inside the software pipeline: chunk
    k+1's Newick parse + GTR eigendecomposition + transfers and chunk
    k-1's annotation decode all happen while chunk k runs on the device,
    so at production depth the wall time tracks the device step rather
    than the sum of all stages.
    """
    from linearham_tpu.io.native import parse_newicks_batch
    from linearham_tpu.utils.exec_cache import cached_call
    from linearham_tpu.utils.profiling import StageTimer, maybe_trace

    timer = StageTimer()
    T = samples.n_samples
    chunk_size = min(chunk_size, T)
    dtype = hmm._dtype

    with timer.stage("host_prepare"):
        # ``rates`` lets run_pipeline share ONE rates array with its
        # streamed TSV writer instead of deriving it twice.
        rates_all = rates if rates is not None else \
            gamma_category_rates_batch(samples.alpha, num_rates)
        er_all = np.asarray(samples.er)
        pi_all = np.asarray(samples.pi)
        # Parse the WHOLE ensemble up front (one native batch call): every
        # chunk then shares one (n_slots, e_max) shape, so there is exactly
        # ONE compiled step for the whole run.
        tb_all = parse_newicks_batch(samples.newicks, hmm.xmsa.labels)
        if tb_all is None:
            tb_all = batch_trees(
                [parse_newick(nw) for nw in samples.newicks],
                hmm.xmsa.labels)
        # Whole-ensemble encoding (wire dtypes applied once): when the
        # GPU kernel runs, this is where the slot-reuse schedules are
        # built (native C++); every chunk below just slices.
        tree_host_all, n_slots = hmm._host_tree(tb_all)

    step_statics = dict(heavy=hmm.space.is_heavy, n_slots=n_slots)

    def step(*args):
        return cached_call(phylo_step_packed_jit, "phylo_step_packed",
                           step_statics, *args)

    key = jax.random.PRNGKey(seed)

    logliks = np.zeros(T)
    paths = []

    def stage_chunk(start):
        """Slice + eigendecompose + enqueue chunk ``start``'s transfers
        (the device_puts are async).  The final chunk repeats row T-1 to
        fill the fixed chunk shape; repeated rows are never drained."""
        idx = np.minimum(np.arange(start, start + chunk_size), T - 1)
        with timer.stage("host_prepare"):
            tree_host = {k: v[idx] for k, v in tree_host_all.items()}
            eig_np = gtr_eigen(er_all[idx], pi_all[idx])
        with timer.stage("device_transfer"):
            from linearham_tpu.utils.wire import device_put_packed

            hmm.place()   # no-op once placed
            np_dtype = np.dtype(jnp.dtype(dtype).name)
            tree_c, eig_c, pi_c, rates_c = device_put_packed((
                tree_host,
                jax.tree.map(
                    lambda a: np.asarray(a, np_dtype), eig_np),
                np.asarray(pi_all[idx], np_dtype),
                np.asarray(rates_all[idx], np_dtype),
            ))
        return tree_c, eig_c, pi_c, rates_c, n_slots

    # Software pipeline over chunks, three threads wide: the main thread
    # only DISPATCHES device steps; chunk k+1's staging (slice/eigen/
    # device_puts) runs on its own single-worker thread, and chunk k-1's
    # drain (host read + decode + streamed write) on another.  Staging
    # for chunk k+1 is submitted BEFORE chunk k's dispatch, so its
    # transfers overlap the device step.  Drains execute in submission
    # order on their one worker, so streamed TSV rows stay ordered.  (The reference interleaves libpll work and TSV output
    # serially per tree, src/PhyloHMM.cpp:393-446.)
    from concurrent.futures import ThreadPoolExecutor

    pending = None   # (start, n_valid, packed_c) awaiting decode
    first_chunk = True
    futures = []
    with maybe_trace(trace_dir), ThreadPoolExecutor(1) as drain_pool, \
            ThreadPoolExecutor(1) as stage_pool:
        def submit_drain(item):
            futures.append(drain_pool.submit(
                _drain_chunk, hmm, timer, logliks, paths, *item,
                on_chunk=on_chunk))

        starts = list(range(0, T, chunk_size))
        if max_chunks is not None:
            starts = starts[:max_chunks]
        staged_f = stage_pool.submit(stage_chunk, starts[0])
        for i, start in enumerate(starts):
            tree_c, eig_c, pi_c, rates_c, n_slots = staged_f.result()
            if i + 1 < len(starts):
                # Next chunk's transfers start NOW, overlapping this
                # chunk's dispatch + device step.
                staged_f = stage_pool.submit(stage_chunk, starts[i + 1])
            key, subkey = jax.random.split(key)
            stage = "compile_and_first_step" if first_chunk \
                else "dispatch"
            with timer.stage(stage):
                path_c = step(
                    hmm._trans, hmm._consts, hmm._xmsa_rows,
                    hmm._naive_bases, tree_c, eig_c, pi_c, rates_c, subkey,
                )
                if first_chunk:
                    # The first dispatch pays compile (unless the
                    # persistent cache hits); block here so --profile
                    # separates compile cost from steady-state time.
                    jax.block_until_ready(path_c)
            first_chunk = False
            if pending is not None:
                submit_drain(pending)
            pending = (start, min(chunk_size, T - start), path_c)
        if pending is not None:
            submit_drain(pending)
        for f in futures:
            f.result()   # propagate drain errors; also the tail barrier

    return PipelineResult(
        samples=samples,
        rates=rates_all,
        lh_loglik=logliks,
        logweight=logliks - samples.rb_loglik,
        annotations=paths,
        timings=timer.as_dict(),
    )


def write_tsv_header(num_rates: int, heavy: bool, outfile: TextIO) -> None:
    """Write the reference-format pipeline TSV header row."""
    cols = (
        ["Iteration", "RBLogLikelihood", "Prior", "alpha"]
        + [f"er[{i}]" for i in range(1, 7)]
        + [f"pi[{i}]" for i in range(1, 5)]
        + ["tree"]
        + [f"sr[{i}]" for i in range(1, num_rates + 1)]
        + ["LHLogLikelihood", "LogWeight", "NaiveSequence",
           "VGene", "V5pDel", "V3pDel", "VFwkInsertion"]
    )
    if heavy:
        cols += ["VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion"]
    else:
        cols += ["VJInsertion"]
    cols += ["JGene", "J5pDel", "J3pDel", "JFwkInsertion"]
    outfile.write("\t".join(cols) + "\n")


def write_tsv_rows(samples: TreeSamples, rates, lh_loglik, logweight,
                   annotations, start: int, n: int, heavy: bool,
                   outfile: TextIO, relative: bool = False) -> None:
    """Write rows [start, start+n) of the pipeline TSV.

    With ``relative=True``, ``lh_loglik``/``logweight``/``annotations``
    are chunk-local (index 0 == row ``start``: the streamed-writer
    contract); otherwise they are full-length and indexed absolutely.
    """
    rel = relative
    if rel and len(annotations) != n:
        raise ValueError(
            f"relative chunk arrays must have length {n}, "
            f"got {len(annotations)}")
    s = samples
    for t in range(start, start + n):
        i = t - start if rel else t
        ann = annotations[i]
        row = (
            [s.iteration[t], s.rb_loglik[t], s.prior[t], s.alpha[t]]
            + list(s.er[t]) + list(s.pi[t])
            + [_COMMENT_RE.sub("", s.newicks[t])]
            + list(rates[t])
            + [lh_loglik[i] if rel else lh_loglik[t],
               logweight[i] if rel else logweight[t], ann.naive_seq,
               ann.vgerm_state, ann.v_5p_del, ann.v_3p_del,
               ann.v_fwk_insertion]
        )
        if heavy:
            row += [ann.vd_insertion, ann.dgerm_state, ann.d_5p_del,
                    ann.d_3p_del, ann.dj_insertion]
        else:
            row += [ann.vd_insertion]
        row += [ann.jgerm_state, ann.j_5p_del, ann.j_3p_del,
                ann.j_fwk_insertion]
        outfile.write("\t".join(str(v) for v in row) + "\n")


def write_output_tsv(result: PipelineResult, heavy: bool,
                     outfile: TextIO) -> None:
    """Write the reference-format pipeline TSV (header + all rows)."""
    write_tsv_header(result.rates.shape[1], heavy, outfile)
    write_tsv_rows(result.samples, result.rates, result.lh_loglik,
                   result.logweight, result.annotations, 0,
                   result.samples.n_samples, heavy, outfile)


def run_pipeline(
    yaml_path: str,
    cluster_ind: int,
    hmm_param_dir: str,
    input_path: str,
    output_path: str,
    num_rates: int,
    seed: int = 0,
    chunk_size: int = 256,
    profile: bool = False,
    trace_dir: Optional[str] = None,
    precision: Optional[str] = None,
) -> PipelineResult:
    """End-to-end: partis YAML + RevBayes TSV -> linearham output TSV.

    ``precision``: f32, f64, or None/auto (the platform policy of
    utils/runtime.py: f32 and the pruning kernel on the GPU, f64 on the
    CPU).
    """
    from linearham_tpu.utils.runtime import enable_persistent_cache, \
        resolve_dtype

    import time as _time

    import threading

    from linearham_tpu.compiler.family_cache import cached_phylo_hmm

    enable_persistent_cache()

    # Initialize the backend and warm the transfer path on a side thread,
    # overlapping the host-side TSV load, family-cache read and ensemble
    # pre-parse instead of serializing inside build_hmm/device_transfer.
    def _dial():
        try:
            jax.block_until_ready(jax.device_put(np.zeros(8, np.float32)))
        except Exception:
            pass

    dial = threading.Thread(target=_dial, daemon=True)
    dial.start()
    t0 = _time.perf_counter()
    samples = load_tree_samples(input_path)
    load_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    hmm = cached_phylo_hmm(yaml_path, cluster_ind, hmm_param_dir,
                           seed=seed, dtype=resolve_dtype(precision),
                           place=False)
    build_s = _time.perf_counter() - t0

    # Start the family-constant transfer NOW on a side thread, overlapping
    # the main thread's ensemble pre-parse.  place() is idempotent and
    # lock-guarded; the staging thread's own call becomes a no-op.
    threading.Thread(target=hmm.place, daemon=True).start()

    # Stream output rows as each chunk drains: the TSV write overlaps the
    # remaining device work instead of serializing after it.  Rows go to
    # a temp file that is renamed into place only on success — a mid-run
    # crash must not leave a truncated TSV that the workflow's freshness
    # check would treat as a completed artifact.
    from linearham_tpu.ops.gtr import gamma_category_rates_batch

    from linearham_tpu.utils.fileio import atomic_write

    rates = gamma_category_rates_batch(samples.alpha, num_rates)
    heavy = hmm.space.is_heavy
    write_s = [0.0]
    with atomic_write(output_path) as fh:
        write_tsv_header(num_rates, heavy, fh)

        def on_chunk(start, n, loglik, anns):
            t0 = _time.perf_counter()
            lw = loglik - samples.rb_loglik[start:start + n]
            write_tsv_rows(samples, rates, loglik, lw, anns, start, n,
                           heavy, fh, relative=True)
            write_s[0] += _time.perf_counter() - t0

        result = run_pipeline_arrays(hmm, samples, num_rates,
                                     seed=seed,
                                     chunk_size=chunk_size,
                                     trace_dir=trace_dir,
                                     on_chunk=on_chunk,
                                     rates=rates)
    if result.timings is not None:
        result.timings["build_hmm"] = build_s
        result.timings["load_trees_tsv"] = load_s
        result.timings["write_tsv"] = write_s[0]
    if profile and result.timings:
        import sys

        total = sum(result.timings.values())
        print(f"# pipeline timings ({samples.n_samples} trees, "
              f"{total * 1e3:.0f}ms total):", file=sys.stderr)
        for k, v in result.timings.items():
            print(f"#   {k}: {v * 1e3:.1f}ms", file=sys.stderr)
    return result
