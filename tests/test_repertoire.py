"""Repertoire-scale multi-family execution: padding/bucketing conformance
and mesh sharding."""

import jax
import numpy as np
import pytest

from linearham_tpu.io.trees_tsv import load_tree_samples
from linearham_tpu.models.phylo_hmm import PhyloHMM
from linearham_tpu.parallel.mesh import make_mesh
from linearham_tpu.parallel.repertoire import (
    FamilyTask,
    run_repertoire,
)
from linearham_tpu.pipeline.run import run_pipeline_arrays

from test_pipeline import _make_tsv


@pytest.fixture(scope="module")
def tasks(fixtures_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rep")
    out = []
    specs = [
        ("phylo_hmm_input.yaml", "hmm_params", 11),
        ("phylo_hmm_input_extra.yaml", "hmm_params", 12),
        ("phylo_hmm_input.yaml", "hmm_params", 13),
        ("phylo_hmm_input_igk.yaml", "igk_hmm_params", 14),
    ]
    for i, (input_name, params, seed) in enumerate(specs):
        tsv = tmp / f"trees_{i}.tsv"
        _make_tsv(tsv, n_rows=4, seed=seed)
        hmm = PhyloHMM(str(fixtures_dir / input_name), 0,
                       str(fixtures_dir / params), seed=0)
        out.append(FamilyTask(hmm=hmm, samples=load_tree_samples(str(tsv))))
    return out


def test_repertoire_matches_per_family(tasks):
    results = run_repertoire(tasks, num_rates=4, seed=0)
    assert len(results) == len(tasks)
    for task, res in zip(tasks, results):
        single = run_pipeline_arrays(task.hmm, task.samples, num_rates=4,
                                     seed=0)
        np.testing.assert_allclose(res.loglik, single.lh_loglik, rtol=1e-9)
        np.testing.assert_allclose(res.logweight, single.logweight,
                                   rtol=1e-9)
        assert len(res.annotations) == task.samples.n_samples
        for ann in res.annotations:
            assert len(ann.naive_seq) == 15


def test_repertoire_ragged_tree_counts(fixtures_dir, tmp_path):
    """Families with unequal ensemble sizes (5/7/9 trees) share a bucket;
    the tree axis pads with dead samples (VERDICT round-1 item 4)."""
    tasks = []
    for i, n_rows in enumerate((5, 7, 9)):
        tsv = tmp_path / f"ragged_{i}.tsv"
        _make_tsv(tsv, n_rows=n_rows, seed=20 + i)
        hmm = PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                       str(fixtures_dir / "hmm_params"), seed=0)
        tasks.append(
            FamilyTask(hmm=hmm, samples=load_tree_samples(str(tsv))))

    results = run_repertoire(tasks, num_rates=4, seed=0)
    for task, res in zip(tasks, results):
        T = task.samples.n_samples
        assert res.loglik.shape == (T,)
        assert len(res.annotations) == T
        single = run_pipeline_arrays(task.hmm, task.samples, num_rates=4,
                                     seed=0)
        np.testing.assert_allclose(res.loglik, single.lh_loglik, rtol=1e-9)
        np.testing.assert_allclose(res.logweight, single.logweight,
                                   rtol=1e-9)


def test_repertoire_on_device_mesh(tasks):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    # The two base-fixture families share one bucket of 2; shard it over a
    # (2 fam, 2 trees) mesh.
    mesh = make_mesh(2, 2)
    pair = [tasks[0], tasks[2]]
    sharded = run_repertoire(pair, num_rates=4, seed=0, mesh=mesh)
    unsharded = run_repertoire(pair, num_rates=4, seed=0)
    for a, b in zip(sharded, unsharded):
        np.testing.assert_allclose(a.loglik, b.loglik, rtol=1e-12)


def test_repertoire_ragged_bucket_on_mesh(fixtures_dir, tmp_path):
    """Mesh-sharded execution of the HARD shapes: a ragged heavy bucket
    (3 families, 5/7/9 trees -> family axis 3 and padded tree axis 9,
    neither divisible by the mesh) plus a lone light-chain family in a
    second bucket.  run_repertoire pads both axes up to mesh multiples
    and slices back; results must match the unsharded run."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    tasks = []
    for i, n_rows in enumerate((5, 7, 9)):
        tsv = tmp_path / f"mr_{i}.tsv"
        _make_tsv(tsv, n_rows=n_rows, seed=40 + i)
        hmm = PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                       str(fixtures_dir / "hmm_params"), seed=0)
        tasks.append(
            FamilyTask(hmm=hmm, samples=load_tree_samples(str(tsv))))
    tsv = tmp_path / "mr_light.tsv"
    _make_tsv(tsv, n_rows=6, seed=50)
    light = PhyloHMM(str(fixtures_dir / "phylo_hmm_input_igk.yaml"), 0,
                     str(fixtures_dir / "igk_hmm_params"), seed=0)
    tasks.append(FamilyTask(hmm=light, samples=load_tree_samples(str(tsv))))

    mesh = make_mesh(2, 2)
    sharded = run_repertoire(tasks, num_rates=4, seed=0, mesh=mesh)
    unsharded = run_repertoire(tasks, num_rates=4, seed=0)
    for i, (a, b) in enumerate(zip(sharded, unsharded)):
        np.testing.assert_allclose(a.loglik, b.loglik, rtol=1e-12,
                                   err_msg=f"family {i}")
        assert len(a.annotations) == tasks[i].samples.n_samples


def test_pooled_repertoire_summary():
    """The shard_map psum/pmax reduction matches a numpy oracle."""
    from linearham_tpu.parallel.mesh import pooled_repertoire_summary

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(0)
    ll = rng.normal(-1000.0, 5.0, size=(4, 8))
    rb = rng.normal(-1010.0, 5.0, size=(4, 8))
    mesh = make_mesh(2, 4)
    out = pooled_repertoire_summary(
        mesh, jax.numpy.asarray(ll), jax.numpy.asarray(rb))

    lw = ll - rb
    e = np.exp(lw - lw.max(axis=1, keepdims=True))
    ess = e.sum(axis=1) ** 2 / (e * e).sum(axis=1)
    assert out["n_trees"] == 32.0
    np.testing.assert_allclose(out["mean_logweight"], lw.mean(), rtol=1e-12)
    np.testing.assert_allclose(out["mean_family_ess"], ess.mean(),
                               rtol=1e-12)


def test_multihost_helpers():
    """Mesh layout and host-side slicing (single process, 8 CPU devices)."""
    import jax

    from linearham_tpu.parallel import multihost

    mesh = multihost.global_family_mesh()
    assert mesh.axis_names == ("fam", "trees")
    assert mesh.devices.shape == (len(jax.devices()), 1)

    mesh2 = multihost.global_family_mesh(n_tree_shards=4)
    assert mesh2.devices.shape == (len(jax.devices()) // 4, 4)

    import pytest
    with pytest.raises(ValueError, match="do not split"):
        multihost.global_family_mesh(n_tree_shards=3)

    items = list(range(10))
    slices = [multihost.process_slice(items, p, 3) for p in range(3)]
    assert slices == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert multihost.process_slice(items) == items  # single process


def test_repertoire_e2e_tsv_and_timings(tasks, tmp_path):
    """The full per-family unit (VERDICT r03 item 4): stack -> device step
    -> decode -> per-family TSV write, with the stage breakdown filled and
    every family's TSV matching the single-family pipeline contract."""
    from linearham_tpu.parallel.repertoire import write_family_output
    from linearham_tpu.pipeline.run import write_output_tsv

    timings = {}
    results = run_repertoire(tasks, num_rates=4, seed=0, timings=timings)
    assert {"stack_families", "device_step", "decode"} <= set(timings)
    assert all(v >= 0 for v in timings.values())

    for f, (task, res) in enumerate(zip(tasks, results)):
        out = tmp_path / f"lh_fam{f}.trees"
        write_family_output(task, res, 4, str(out))
        lines = out.read_text().rstrip("\n").split("\n")
        assert len(lines) == task.samples.n_samples + 1
        header = lines[0].split("\t")
        assert header[:4] == ["Iteration", "RBLogLikelihood", "Prior",
                              "alpha"]
        assert "LHLogLikelihood" in header and "NaiveSequence" in header
        ll_col = header.index("LHLogLikelihood")
        for t, line in enumerate(lines[1:]):
            fields = line.split("\t")
            assert len(fields) == len(header)
            assert float(fields[ll_col]) == pytest.approx(
                res.loglik[t], rel=1e-6)
        # Light chain uses the VJInsertion column variant.
        if not task.hmm.space.is_heavy:
            assert "VJInsertion" in header and "DGene" not in header


def _stacked_family_batch(encoding, n_fam=4, n_trees=4):
    """Host-stacked fused-step inputs for n_fam same-shape synthetic
    families, their trees in the ``encoding`` ('jnp' TreeBatch arrays or
    'kernel' slot-reuse schedules)."""
    import jax.numpy as jnp

    from linearham_tpu.io.newick import batch_trees, parse_newick
    from linearham_tpu.io.schedule import build_schedule
    from linearham_tpu.ops.gtr import gamma_category_rates_batch, gtr_eigen
    from linearham_tpu.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=5, n_v=2, n_d=2, n_j=2, v_len=40, d_len=16,
                      j_len=14, seed=4)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32)
    per_family = []
    for f in range(n_fam):
        s = make_tree_samples(fam, n_trees, seed=f)
        tb = batch_trees([parse_newick(nw) for nw in s.newicks],
                         hmm.xmsa.labels)
        if encoding == "kernel":
            sc = build_schedule(tb)
            tree = {"sched_src": sc.src, "sched_penc": sc.penc,
                    "sched_len": sc.length, "sched_root": sc.root}
            n_slots = sc.n_slots
        else:
            tree = {"tip_perm": tb.tip_perm, "tip_parent": tb.tip_parent,
                    "tip_length": tb.tip_length,
                    "edge_child": tb.edge_child,
                    "edge_parent": tb.edge_parent,
                    "edge_length": tb.edge_length,
                    "root_slot": tb.root_slot}
            n_slots = tb.n_slots
        f32 = lambda a: np.asarray(a, np.float32)           # noqa: E731
        tree = {k: (f32(v) if np.issubdtype(np.asarray(v).dtype,
                                            np.floating) else np.asarray(v))
                for k, v in tree.items()}
        per_family.append((
            hmm._trans_np, hmm._consts_np, hmm._xmsa_rows_np,
            hmm._naive_bases_np, tree,
            jax.tree.map(f32, gtr_eigen(s.er, s.pi)), f32(s.pi),
            f32(gamma_category_rates_batch(s.alpha, 4)),
            np.asarray(jax.random.PRNGKey(f))))
    trans = {k: np.asarray(v, np.float32) if np.issubdtype(
        np.asarray(v).dtype, np.floating) else v
        for k, v in per_family[0][0].items()}
    per_family = [(trans,) + p[1:] for p in per_family]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *per_family)
    return stacked, n_slots


@pytest.mark.parametrize("encoding", ["jnp", "kernel"])
def test_sharded_pipeline_matches_unsharded(encoding):
    """sharded_pipeline on a (fam=2, trees=2) mesh of virtual CPU devices
    prunes under shard_map (the kernel's custom call cannot be
    partitioned) and reproduces the unsharded step: log-likelihoods and
    sampled paths."""
    from functools import partial

    from linearham_tpu.parallel.mesh import (multi_family_step,
                                             shard_family_batch,
                                             sharded_pipeline)

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    stacked, n_slots = _stacked_family_batch(encoding)
    mesh = make_mesh(2, 2)

    jaxpr = jax.make_jaxpr(partial(
        multi_family_step, heavy=True, n_slots=n_slots, mesh=mesh))(
        *stacked)
    prims = [e.primitive.name for e in jaxpr.jaxpr.eqns]
    assert "shard_map" in prims
    shard = next(e for e in jaxpr.jaxpr.eqns
                 if e.primitive.name == "shard_map")
    inner = [e.primitive.name for e in shard.params["jaxpr"].eqns]
    assert ("ffi_call" in inner) == (encoding == "kernel")

    ll, path = sharded_pipeline(mesh, heavy=True, n_slots=n_slots)(
        *shard_family_batch(mesh, *stacked))
    ll_ref, path_ref = jax.jit(partial(
        multi_family_step, heavy=True, n_slots=n_slots))(*stacked)
    assert ll.shape == (4, 4) and np.isfinite(np.asarray(ll)).all()
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(path.vd_idx),
                                  np.asarray(path_ref.vd_idx))
