"""Production-precision plumbing: f32 vs f64 agreement, platform policy.

The reference runs everything in f64 (+2^256 block scaling); production
GPU runs here use f32 so the CUDA pruning kernel engages.  This pins the
f32 pipeline log-likelihoods to the f64 conformance path within a
documented tolerance (VERDICT round-1 item 3), and the policy that picks
dtype and pruning path per platform.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from linearham_tpu.models.phylo_hmm import PhyloHMM
from linearham_tpu.pipeline.run import run_pipeline_arrays
from linearham_tpu.utils.runtime import platform_policy, resolve_dtype
from linearham_tpu.utils.synth import make_family, make_tree_samples

# Documented tolerance: ~370-site family, ~860 xMSA columns, 4 rate cats.
# f32 pruning accumulates O(1e-5) relative error per site partial; the
# summed log-likelihood (magnitude ~1.3e3) stays within this bound.
F32_LOGLIK_ATOL = 0.05


@pytest.fixture(scope="module")
def family():
    return make_family(n_seqs=6, seed=3)


def _pipeline_logliks(family, dtype, n_trees=16):
    hmm = PhyloHMM.from_parts(
        family.locus, family.flexbounds, family.relpos, family.genes,
        family.msa, family.unique_ids, family.n_sites, seed=0, dtype=dtype,
    )
    samples = make_tree_samples(family, n_trees, seed=7)
    result = run_pipeline_arrays(hmm, samples, num_rates=4, seed=0)
    return result.lh_loglik


def test_f32_pipeline_matches_f64(family):
    ll64 = _pipeline_logliks(family, jnp.float64)
    ll32 = _pipeline_logliks(family, jnp.float32)
    assert np.all(np.isfinite(ll64)) and np.all(np.isfinite(ll32))
    np.testing.assert_allclose(ll32, ll64, rtol=0, atol=F32_LOGLIK_ATOL)


def test_f32_kernel_deep_tree_error_bound():
    """f32 error at 120+ tips, where round-off compounds most: the f32
    pruning kernel's site log-likelihoods (host build, the same
    arithmetic as the GPU kernel) vs the f64 XLA path, bounded per site
    AND as a summed (total-loglik) error (VERDICT round-2 item 7; extends
    the 6-seq bound above to depth)."""
    import jax

    from linearham_tpu.ops.pruning import site_log_likelihoods
    from linearham_tpu.ops.pruning_kernel import site_log_likelihoods_kernel
    from linearham_tpu.pipeline.run import prepare_ensemble

    fam = make_family(n_seqs=120, seed=17, mutation_rate=0.04)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32,
    )
    samples = make_tree_samples(fam, 2, seed=17)
    tree_arrays, eig, rates, n_slots = prepare_ensemble(hmm, samples, 4)
    assert "tip_perm" in tree_arrays      # the CPU policy: TreeBatch arrays
    assert n_slots >= 120 and hmm.xmsa.n_cols >= 700

    def to_dtype(dt):
        def conv(a):
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                return jnp.asarray(a, dt)
            return jnp.asarray(a)
        return conv

    t64 = {k: to_dtype(jnp.float64)(v) for k, v in tree_arrays.items()}
    eig64 = jax.tree.map(to_dtype(jnp.float64), eig)
    pi64 = to_dtype(jnp.float64)(samples.pi)
    rates64 = to_dtype(jnp.float64)(rates)

    def per_tree(eig_t, pi_t, rates_t, perm, tparent, tlen, echild,
                 eparent, elen, root):
        return site_log_likelihoods(
            eig_t, pi_t, rates_t, hmm._xmsa_rows[perm], tparent, tlen,
            echild, eparent, elen, root, n_slots)

    want64 = np.asarray(jax.vmap(per_tree)(
        eig64, pi64, rates64, t64["tip_perm"], t64["tip_parent"],
        t64["tip_length"], t64["edge_child"], t64["edge_parent"],
        t64["edge_length"], t64["root_slot"]))

    from linearham_tpu.io.newick import TreeBatch
    from linearham_tpu.io.schedule import build_schedule

    sched = build_schedule(TreeBatch(
        tip_perm=np.asarray(tree_arrays["tip_perm"]),
        tip_parent=np.asarray(tree_arrays["tip_parent"]),
        tip_length=np.asarray(tree_arrays["tip_length"]),
        edge_child=np.asarray(tree_arrays["edge_child"]),
        edge_parent=np.asarray(tree_arrays["edge_parent"]),
        edge_length=np.asarray(tree_arrays["edge_length"]),
        root_slot=np.asarray(tree_arrays["root_slot"]),
        n_slots=n_slots,
    ))
    got32 = np.asarray(site_log_likelihoods_kernel(
        jax.tree.map(to_dtype(jnp.float32), eig),
        to_dtype(jnp.float32)(samples.pi), to_dtype(jnp.float32)(rates),
        hmm._xmsa_rows, jnp.asarray(sched.src), jnp.asarray(sched.penc),
        to_dtype(jnp.float32)(sched.length), jnp.asarray(sched.root),
        n_slots=sched.n_slots))

    diff = np.abs(got32 - want64)
    # Documented deep-tree bounds: per-site partials stay within 2e-3 in
    # log space at 120 tips; the summed per-tree error (the quantity that
    # reaches the reported log-likelihood) stays within the same 0.05
    # budget the 6-seq pipeline bound above pins.
    assert diff.max() < 2e-3, diff.max()
    assert np.abs((got32 - want64).sum(axis=1)).max() < 0.05


def test_resolve_dtype_explicit():
    assert resolve_dtype("f32") == jnp.float32
    assert resolve_dtype("f64") == jnp.float64
    # auto on the CPU test backend -> conformance precision
    assert resolve_dtype(None) == jnp.float64
    with pytest.raises(ValueError):
        resolve_dtype("bf16")


@pytest.mark.parametrize("platform,precision,kernel", [
    ("cpu", "f64", False),
    ("gpu", "f32", True),
])
def test_platform_policy(platform, precision, kernel):
    pol = platform_policy(platform)
    assert (pol.platform, pol.precision, pol.pruning_kernel) == (
        platform, precision, kernel)


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_platform_policy_rejects_unknown_platform(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform_policy(platform)


def test_cpu_policy_selects_f64_and_jnp_pruning(family):
    """On the CPU: auto precision is f64, and even an f32 ensemble is
    encoded for the jnp path (the kernel is the GPU's)."""
    from linearham_tpu.io.newick import batch_trees, parse_newick
    from linearham_tpu.models.phylo_hmm import ensemble_encoding
    from linearham_tpu.utils.runtime import use_pruning_kernel

    assert platform_policy().platform == "cpu"
    assert resolve_dtype("auto") == jnp.float64
    assert not use_pruning_kernel(jnp.float32)
    samples = make_tree_samples(family, 2, seed=1)
    labels = ["naive"] + list(family.unique_ids)
    tb = batch_trees([parse_newick(nw) for nw in samples.newicks], labels)
    enc, _ = ensemble_encoding(tb, jnp.float32)
    assert "tip_perm" in enc and "sched_src" not in enc


def test_phylo_step_matmuls_use_highest_precision(family):
    """Every dot_general the fused step traces (emissions, naive
    correction, forward recursions, FFBS) carries Precision.HIGHEST, so
    no f32 product may drop to TF32 on the GPU."""
    import jax

    from linearham_tpu.models.phylo_hmm import phylo_step
    from linearham_tpu.pipeline.run import prepare_ensemble

    hmm = PhyloHMM.from_parts(
        family.locus, family.flexbounds, family.relpos, family.genes,
        family.msa, family.unique_ids, family.n_sites, seed=0,
        dtype=jnp.float32)
    samples = make_tree_samples(family, 3, seed=2)
    tree, eig, rates, n_slots = prepare_ensemble(hmm, samples, 4)
    f32 = lambda a: jnp.asarray(a, jnp.float32)          # noqa: E731
    tree = {k: (f32(v) if np.issubdtype(np.asarray(v).dtype, np.floating)
                else jnp.asarray(v)) for k, v in tree.items()}
    jaxpr = jax.make_jaxpr(
        lambda *a: phylo_step(*a, heavy=True, n_slots=n_slots))(
        hmm._trans, hmm._consts, hmm._xmsa_rows, hmm._naive_bases, tree,
        jax.tree.map(f32, eig), f32(samples.pi), f32(rates),
        jax.random.PRNGKey(0))
    found = list(_dots(jaxpr.jaxpr))
    assert len(found) >= 5, "expected emission and forward contractions"
    for eqn in found:
        assert _is_highest(eqn), f"dot without HIGHEST precision: {eqn}"


def _dots(jx):
    for eqn in jx.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in eqn.params.values():
            for j in (sub if isinstance(sub, (list, tuple)) else [sub]):
                if hasattr(j, "jaxpr"):
                    yield from _dots(j.jaxpr)
                elif hasattr(j, "eqns"):
                    yield from _dots(j)


def _is_highest(eqn) -> bool:
    import jax

    prec = eqn.params.get("precision")
    return prec is not None and all(
        p == jax.lax.Precision.HIGHEST
        for p in (prec if isinstance(prec, tuple) else (prec,)))


def test_emission_matmuls_use_highest_precision():
    """Regression guard for the importance-weight fix: the region-emission
    contractions sum hundreds of ~-26-magnitude site log-likelihoods, and
    a reduced-precision f32 matmul (bf16 passes, or TF32 on the GPU)
    random-walks the per-tree loglik error to several nats at 312-seq
    depth, directly distorting the softmax importance weights.  Every dot
    in region_emissions must therefore carry Precision.HIGHEST."""
    import jax

    from linearham_tpu.models.phylo_hmm import region_emissions
    from linearham_tpu.models.phylo_hmm import _gather_consts

    fam = make_family(n_seqs=4, seed=2)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32)

    def f(site_ll):
        return region_emissions(site_ll, hmm._consts_np, heavy=True)

    jaxpr = jax.make_jaxpr(f)(
        jnp.zeros((3, hmm.xmsa.n_cols), jnp.float32))

    def dots(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in eqn.params.values():
                if hasattr(sub, "jaxpr"):
                    yield from dots(sub.jaxpr)

    found = list(dots(jaxpr.jaxpr))
    assert found, "no dot_general in region_emissions?"
    for eqn in found:
        assert _is_highest(eqn), (
            f"emission dot without HIGHEST precision: {eqn}")
