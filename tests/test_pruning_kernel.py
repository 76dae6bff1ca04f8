"""The pruning kernel (native/pruning.cu) vs the jnp reference path.

On the CPU the kernel's host build runs the same per-thread arithmetic
serially through the same FFI wrapper, so the numerics contract
(treatAmbiguousAsGap N handling, slot-reuse schedules with first-write
flags, skipped padding entries, power-of-two rescaling, rate mixing) and
the wrapper (shapes, batch dimensions, vmap) are pinned on every
platform.  Tests marked ``gpu`` run the compiled CUDA kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linearham_tpu.io.schedule import build_schedule
from linearham_tpu.models.phylo_hmm import PhyloHMM
from linearham_tpu.ops.pruning import site_log_likelihoods
from linearham_tpu.ops.pruning_kernel import site_log_likelihoods_kernel
from linearham_tpu.utils.synth import make_family, make_tree_samples


def _build(seed, n_seqs, T, num_rates=4, **kw):
    """(hmm, tree dict, sched args, eig, pi, rates, n_slots) in f32."""
    fam = make_family(n_seqs=n_seqs, seed=seed, **kw)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32,
    )
    samples = make_tree_samples(fam, T, seed=seed)
    # Build BOTH encodings explicitly (prepare_ensemble picks one per
    # platform): TreeBatch arrays feed the jnp reference path, the
    # slot-reuse schedule feeds the kernel.
    from linearham_tpu.io.native import parse_newicks_batch
    from linearham_tpu.io.newick import batch_trees, parse_newick
    from linearham_tpu.ops.gtr import (gamma_category_rates_batch,
                                       gtr_eigen)

    tb = parse_newicks_batch(samples.newicks, hmm.xmsa.labels)
    if tb is None:
        tb = batch_trees([parse_newick(nw) for nw in samples.newicks],
                         hmm.xmsa.labels)
    n_slots = tb.n_slots
    ta = {
        "tip_perm": tb.tip_perm,
        "tip_parent": tb.tip_parent,
        "tip_length": np.asarray(tb.tip_length, np.float64),
        "edge_child": tb.edge_child,
        "edge_parent": tb.edge_parent,
        "edge_length": np.asarray(tb.edge_length, np.float64),
        "root_slot": tb.root_slot,
    }
    rates = gamma_category_rates_batch(samples.alpha, num_rates)
    eig = gtr_eigen(samples.er, samples.pi)
    sched = build_schedule(tb)

    def to_dev(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(a, jnp.float32)
        return jnp.asarray(a)

    tree = {k: to_dev(v) for k, v in ta.items()}
    sched_args = (to_dev(sched.src), to_dev(sched.penc),
                  to_dev(sched.length), to_dev(sched.root))
    eig = jax.tree.map(to_dev, eig)
    return (hmm, tree, sched_args, eig, to_dev(samples.pi),
            to_dev(rates), n_slots, sched.n_slots)


def _want(hmm, tree, eig, pi, rates, n_slots, rows=None):
    rows_arr = hmm._xmsa_rows if rows is None else rows

    def per_tree(eig_t, pi_t, rates_t, perm, tparent, tlen, echild,
                 eparent, elen, root):
        return site_log_likelihoods(
            eig_t, pi_t, rates_t, rows_arr[perm], tparent, tlen,
            echild, eparent, elen, root, n_slots)

    return jax.vmap(per_tree)(
        eig, pi, rates, tree["tip_perm"], tree["tip_parent"],
        tree["tip_length"], tree["edge_child"], tree["edge_parent"],
        tree["edge_length"], tree["root_slot"])


@pytest.fixture(scope="module")
def ensemble():
    return _build(3, 5, 9)


def test_kernel_matches_jnp_path(ensemble):
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = ensemble
    want = _want(hmm, tree, eig, pi, rates, n_slots)
    got = site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *sched_args, n_slots=s_slots)
    assert got.shape == want.shape and got.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_kernel_handles_ambiguous_tips(ensemble):
    """A tip row of all-N must contribute exactly nothing (msg == 1)."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = ensemble
    # Point every tree's tip slot 0 at a new all-N xMSA row.  In the
    # schedule encoding tip rows live in sched_src (is_tip entries); remap
    # every reference to the original row of tip slot 0.
    n_rows = hmm._xmsa_rows.shape[0]
    rows_n = jnp.concatenate(
        [hmm._xmsa_rows, jnp.full((1, hmm._xmsa_rows.shape[1]), 4,
                                  hmm._xmsa_rows.dtype)], axis=0)
    src, penc, length, root = sched_args
    target = tree["tip_perm"][:, 0:1]                     # [T, 1]
    is_tip = (penc >= 0) & ((penc & 1) == 1)
    src_n = jnp.where(is_tip & (src == target), n_rows, src)

    perm_n = tree["tip_perm"].at[:, 0].set(n_rows)
    tree_n = dict(tree, tip_perm=perm_n)
    want = _want(hmm, tree_n, eig, pi, rates, n_slots, rows=rows_n)
    got = site_log_likelihoods_kernel(
        eig, pi, rates, rows_n, src_n, penc, length, root, n_slots=s_slots)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_kernel_deep_tree_production_width():
    """A 300+-tip family at production xMSA width: pins the
    schedule-driven kernel at the shapes the Liao CH103 dataset produces.
    With slot reuse a tree needs ~8 live slots, which is what lets a GPU
    block keep them all in shared memory."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = _build(
        13, 300, 1, mutation_rate=0.03)
    assert n_slots >= 300 and hmm.xmsa.n_cols >= 700
    assert s_slots <= 16      # the collapse this kernel design is built on
    want = _want(hmm, tree, eig, pi, rates, n_slots)
    got = site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *sched_args, n_slots=s_slots)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=5e-4, atol=5e-4)


def test_kernel_single_rate_and_zero_branches():
    """R=1 shapes and t=0 edges with conflicting tips (-inf sites) must
    agree with the jnp path."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = _build(
        11, 4, 3, num_rates=1)
    assert rates.shape[1] == 1
    # Zero every branch: identity transitions, so any site where two tips
    # under a cherry disagree has exactly zero likelihood.
    tree = dict(tree,
                tip_length=jnp.zeros_like(tree["tip_length"]),
                edge_length=jnp.zeros_like(tree["edge_length"]))
    src, penc, length, root = sched_args
    sched_args = (src, penc, jnp.zeros_like(length), root)

    want = np.asarray(_want(hmm, tree, eig, pi, rates, n_slots))
    got = np.asarray(site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *sched_args, n_slots=s_slots))

    assert np.isneginf(want).any()          # the scenario actually fires
    # Whether an impossible site lands at exactly -inf or at the log of an
    # f32 eigenbasis round-off residual (~-30) is implementation noise; the
    # contract is: no NaNs, impossible sites hugely negative, possible
    # sites matching.
    assert not np.isnan(got).any()
    impossible = want < -15
    assert (got[impossible] < -15).all()
    ok = ~impossible
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-4, atol=2e-4)


def test_kernel_skips_padding_entries(ensemble):
    """Entries with penc -1 are skipped: appending a block of them (as a
    repertoire bucket pads a shallower family's schedules) changes no
    output bit."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = ensemble
    src, penc, length, root = sched_args
    T = src.shape[0]
    pad = 7
    padded = (jnp.concatenate([src, jnp.zeros((T, pad), src.dtype)], 1),
              jnp.concatenate([penc, jnp.full((T, pad), -1, penc.dtype)], 1),
              jnp.concatenate([length, jnp.ones((T, pad), length.dtype)], 1),
              root)
    base = site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *sched_args, n_slots=s_slots)
    got = site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *padded, n_slots=s_slots)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(base))


def test_kernel_vmap_folds_families_into_one_call(ensemble):
    """A vmap over families (the repertoire path) lowers to ONE kernel
    call over all their trees, each family reading its own xMSA codes,
    and equals the per-family calls."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = ensemble
    rows = hmm._xmsa_rows
    rows2 = jnp.where(rows < 4, (rows + 1) % 4, rows)    # a second family
    stack = lambda a: jnp.stack([a, a[::-1]])            # noqa: E731
    args = (jax.tree.map(stack, eig), stack(pi), stack(rates),
            jnp.stack([rows, rows2])) + tuple(stack(a) for a in sched_args)

    def f(*a):
        return jax.vmap(
            lambda *b: site_log_likelihoods_kernel(*b, n_slots=s_slots))(*a)

    calls = [e for e in jax.make_jaxpr(f)(*args).jaxpr.eqns
             if e.primitive.name == "ffi_call"]
    assert len(calls) == 1
    got = np.asarray(f(*args))
    for k in range(2):
        one = site_log_likelihoods_kernel(
            *jax.tree.map(lambda a: a[k], args), n_slots=s_slots)
        np.testing.assert_array_equal(got[k], np.asarray(one))


def test_kernel_rejects_too_many_rates(ensemble):
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = ensemble
    wide = jnp.tile(rates[:, :1], (1, 17))
    with pytest.raises(ValueError, match="rate categories"):
        site_log_likelihoods_kernel(
            eig, pi, wide, hmm._xmsa_rows, *sched_args, n_slots=s_slots)


@pytest.mark.gpu
@pytest.mark.parametrize("num_rates", [4, 1])
def test_kernel_compiled_on_gpu_matches_f64_reference(gpu, num_rates):
    """The COMPILED CUDA kernel vs the f64 jnp path on the card."""
    hmm, tree, sched_args, eig, pi, rates, n_slots, s_slots = _build(
        5, 30, 16, num_rates=num_rates)
    f64 = lambda a: jnp.asarray(a, jnp.float64)          # noqa: E731
    tree64 = {k: (f64(v) if jnp.issubdtype(v.dtype, jnp.floating) else v)
              for k, v in tree.items()}
    want = jax.jit(lambda: _want(
        hmm, tree64, jax.tree.map(f64, eig), f64(pi), f64(rates),
        n_slots))()
    got = jax.jit(lambda: site_log_likelihoods_kernel(
        eig, pi, rates, hmm._xmsa_rows, *sched_args, n_slots=s_slots))()
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)
