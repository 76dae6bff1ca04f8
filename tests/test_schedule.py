"""Slot-reuse pruning schedules (io/schedule.py, native/schedule.cpp).

Checks three things: (1) the Python and native C++ builders are
bit-identical; (2) executing a schedule with an independent numpy f64
interpreter reproduces ops.pruning.site_log_likelihoods exactly; (3) the
peak live-slot count actually collapses (the whole point: the GPU
kernel's shared-memory slot file must stay ~log2(n_tips) at any family
depth)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linearham_tpu.io.native import build_schedule_batch_native
from linearham_tpu.io.newick import TreeBatch
from linearham_tpu.io.schedule import build_schedule_python
from linearham_tpu.models.phylo_hmm import PhyloHMM
from linearham_tpu.ops.pruning import site_log_likelihoods
from linearham_tpu.pipeline.run import prepare_ensemble
from linearham_tpu.utils.synth import make_family, make_tree_samples


def _tree_batch(tree_arrays, n_slots):
    return TreeBatch(
        tip_perm=np.asarray(tree_arrays["tip_perm"]),
        tip_parent=np.asarray(tree_arrays["tip_parent"]),
        tip_length=np.asarray(tree_arrays["tip_length"]),
        edge_child=np.asarray(tree_arrays["edge_child"]),
        edge_parent=np.asarray(tree_arrays["edge_parent"]),
        edge_length=np.asarray(tree_arrays["edge_length"]),
        root_slot=np.asarray(tree_arrays["root_slot"]),
        n_slots=n_slots,
    )


def _make(seed, n_seqs, T, num_rates=4, **kw):
    fam = make_family(n_seqs=n_seqs, seed=seed, **kw)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float64)
    samples = make_tree_samples(fam, T, seed=seed)
    ta, eig, rates, n_slots = prepare_ensemble(hmm, samples, num_rates)
    return hmm, samples, ta, eig, rates, n_slots


def _exec_schedule(sched, t, row_codes, eig, pi, rates, stride=4):
    """Independent numpy f64 interpreter of one tree's schedule (the
    same per-entry semantics the GPU kernel implements)."""
    R = rates.shape[0]
    X = row_codes.shape[1]
    partials = np.full((sched.n_slots, R, 4, X), np.nan)
    scale = np.zeros((R, X))
    u, uinv, lam = (np.asarray(eig.u), np.asarray(eig.u_inv),
                    np.asarray(eig.lam))
    for k in range(sched.n_entries):
        src = int(sched.src[t, k])
        penc = int(sched.penc[t, k])
        ln = float(sched.length[t, k])
        if penc < 0:
            continue          # padding entry
        p, first, is_tip = penc >> 2, (penc >> 1) & 1, penc & 1
        P = np.maximum(np.einsum(
            "ik,rk,kj->rij", u,
            np.exp(lam[None, :] * ln * rates[:, None]), uinv), 0)
        if is_tip:
            code = row_codes[src]
            oh = (code[None, :] == np.arange(4)[:, None]).astype(float) \
                + (code[None, :] >= 4)
            msg = np.einsum("rij,jx->rix", P, oh)
        else:
            msg = np.einsum("rij,rjx->rix", P, partials[src])
        upd = msg if first else partials[p] * msg
        if k % stride == stride - 1:
            m = np.max(upd, axis=1, keepdims=True)
            m = np.where(m > 0, m, 1.0)
            upd = upd / m
            scale += np.log(m[:, 0, :])
        partials[p] = upd
    root = partials[int(sched.root[t])]
    lik = np.einsum("i,rix->rx", np.asarray(pi), root)
    pr = np.log(lik) + scale
    mx = pr.max(axis=0)
    safe = np.where(np.isfinite(mx), mx, 0.0)
    return safe + np.log(np.exp(pr - safe).sum(axis=0)) - np.log(R)


@pytest.mark.parametrize("seed,n_seqs,T", [(3, 5, 9), (7, 20, 6)])
def test_native_builder_matches_python(seed, n_seqs, T):
    _, _, ta, _, _, n_slots = _make(seed, n_seqs, T)
    tb = _tree_batch(ta, n_slots)
    py = build_schedule_python(tb)
    nat = build_schedule_batch_native(tb)
    assert nat is not None, "native schedule builder unavailable"
    np.testing.assert_array_equal(py.src, nat.src)
    np.testing.assert_array_equal(py.penc, nat.penc)
    np.testing.assert_array_equal(py.length, nat.length)
    np.testing.assert_array_equal(py.root, nat.root)
    assert py.n_slots == nat.n_slots


@pytest.mark.parametrize("seed,n_seqs,T", [(3, 5, 9), (13, 60, 4)])
def test_schedule_execution_matches_pruning(seed, n_seqs, T):
    hmm, samples, ta, eig, rates, n_slots = _make(seed, n_seqs, T)
    sched = build_schedule_python(_tree_batch(ta, n_slots))
    rows = np.asarray(hmm._xmsa_rows)
    for t in range(min(T, 3)):
        want = np.asarray(site_log_likelihoods(
            jax.tree.map(
                lambda a, tt=t: jnp.asarray(np.asarray(a)[tt],
                                            jnp.float64), eig),
            jnp.asarray(samples.pi[t], jnp.float64),
            jnp.asarray(rates[t], jnp.float64),
            jnp.asarray(rows[ta["tip_perm"][t]]),
            jnp.asarray(ta["tip_parent"][t]),
            jnp.asarray(ta["tip_length"][t], jnp.float64),
            jnp.asarray(ta["edge_child"][t]),
            jnp.asarray(ta["edge_parent"][t]),
            jnp.asarray(ta["edge_length"][t], jnp.float64),
            jnp.asarray(ta["root_slot"][t]), n_slots))
        got = _exec_schedule(
            sched, t, rows,
            jax.tree.map(lambda a, tt=t: np.asarray(a)[tt], eig),
            samples.pi[t], np.asarray(rates[t]))
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10,
                                   atol=1e-10)


def test_peak_slots_collapse():
    """The whole point: peak live slots ~log2(tips), not one per node."""
    for n_seqs, bound in [(20, 8), (60, 8), (150, 16)]:
        _, _, ta, _, _, n_slots = _make(5, n_seqs, 2)
        sched = build_schedule_python(_tree_batch(ta, n_slots))
        assert sched.n_slots <= bound, (n_seqs, sched.n_slots)
        assert n_slots >= n_seqs  # the non-reused encoding really is deep


def test_schedule_invariants():
    """Every slot is stored (first=1) before any read; padding entries
    (penc -1) trail the real ones; entry counts match tips+edges; every
    slot index fits n_slots."""
    _, _, ta, _, _, n_slots = _make(11, 12, 5)
    tb = _tree_batch(ta, n_slots)
    sched = build_schedule_python(tb)
    n_tips = tb.tip_perm.shape[1]
    for t in range(sched.n_trees):
        written = set()
        n_real = 0
        for k in range(sched.n_entries):
            penc = int(sched.penc[t, k])
            src = int(sched.src[t, k])
            p, first, is_tip = penc >> 2, (penc >> 1) & 1, penc & 1
            if penc < 0:
                # padding only after the tree's real entries
                assert (sched.penc[t, k:] == -1).all()
                break
            assert 0 <= p < sched.n_slots
            n_real += 1
            if not is_tip:
                assert src in written, "read of an unwritten slot"
            if first:
                written.add(p)
            else:
                assert p in written, "multiply into an unwritten slot"
        root = int(sched.root[t])
        assert root in written
        n_edges = int(tb.root_slot[t])   # post-order: root = edge count
        assert n_real == n_tips + n_edges


def test_schedule_polytomies_and_caterpillar():
    """Non-binary topologies: a star (one internal node, all tips), a
    polytomy mixed with nesting, and a pectinate caterpillar all build
    valid slot-reuse schedules whose execution matches the XLA path.
    The caterpillar also pins the slot-reuse claim: peak stays tiny even
    when the tree is maximally deep."""
    from linearham_tpu.io.native import build_schedule_batch_native
    from linearham_tpu.io.newick import batch_trees, parse_newick
    from linearham_tpu.models.phylo_hmm import PhyloHMM
    from linearham_tpu.utils.synth import make_family

    fam = make_family(n_seqs=6, seed=9)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float64)
    labels = ["naive"] + list(fam.unique_ids)  # 7 tips
    t = {lab: f"{lab}:0.{i + 1}" for i, lab in enumerate(labels)}
    star = "(" + ",".join(t[lab] for lab in labels) + ");"
    mixed = (f"(({t[labels[0]]},{t[labels[1]]},{t[labels[2]]}):0.3,"
             f"{t[labels[3]]},({t[labels[4]]},{t[labels[5]]},"
             f"{t[labels[6]]}):0.2);")
    cat = t[labels[0]]
    for lab in labels[1:]:
        cat = f"({cat},{t[lab]}):0.15"
    cat += ";"

    tb = batch_trees([parse_newick(nw) for nw in (star, mixed, cat)],
                     labels)
    for builder in (build_schedule_python, build_schedule_batch_native):
        sched = builder(tb)
        assert sched is not None
        assert sched.n_slots == 8   # caterpillar depth 6 still ~2 live
        rows = np.asarray(hmm._xmsa_rows)
        rng = np.random.default_rng(0)
        pi = rng.dirichlet([5] * 4)
        er = rng.uniform(0.5, 2.0, 6)
        from linearham_tpu.ops.gtr import gtr_eigen
        eig = gtr_eigen(er, pi)
        rates = np.array([0.5, 1.0, 1.5, 1.0])
        for t_i in range(3):
            want = np.asarray(site_log_likelihoods(
                jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), eig),
                jnp.asarray(pi), jnp.asarray(rates),
                jnp.asarray(rows[tb.tip_perm[t_i]]),
                jnp.asarray(tb.tip_parent[t_i]),
                jnp.asarray(tb.tip_length[t_i]),
                jnp.asarray(tb.edge_child[t_i]),
                jnp.asarray(tb.edge_parent[t_i]),
                jnp.asarray(tb.edge_length[t_i]),
                jnp.asarray(tb.root_slot[t_i]), tb.n_slots))
            got = _exec_schedule(sched, t_i, rows, eig, pi, rates)
            fin = np.isfinite(want)
            assert (np.isfinite(got) == fin).all()
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10,
                                       atol=1e-10)
