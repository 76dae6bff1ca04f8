"""PhyloHMM: V(D)J HMM with phylogenetic-tree emission probabilities.

Emissions are per-site Felsenstein likelihoods over the xMSA conditional on
the hidden naive base (divided by the naive base's stationary probability,
since the HMM supplies the naive prior; reference: src/PhyloHMM.cpp:220-238).
The whole posterior tree ensemble runs as one batched jitted computation:
GTR eigendecomposition, pruning, emission gathers, forward, and FFBS are
all vmapped/batched over trees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from linearham_tpu.compiler.compiled import CompiledFamily, compile_family
from linearham_tpu.compiler.state_space import build_state_space
from linearham_tpu.compiler.xmsa import Xmsa, build_xmsa, segment_matrix
from linearham_tpu.io.germline import load_gene_map
from linearham_tpu.io.newick import TreeBatch, batch_trees, parse_newick
from linearham_tpu.io.partis import ClusterData, load_cluster
from linearham_tpu.models.decode import (Annotation, decode_path,
                                         decode_paths_batch)
from linearham_tpu.ops.ffbs import (SampledPath, sample_path,
                                    sample_paths_batch)
from linearham_tpu.ops.forward import forward
from linearham_tpu.ops.gtr import gamma_category_rates, gtr_eigen
from linearham_tpu.ops.pruning import site_log_likelihoods

NEG_INF = -np.inf


def ensemble_encoding(tb: TreeBatch, dtype):
    """Host tree-batch encoding for phylo_step: (arrays dict, n_slots).

    When the pruning kernel will consume the ensemble (the platform policy,
    utils/runtime.py), trees ship as slot-reuse pruning schedules
    (io/schedule.py: peak live slots is ~log2(n_tips), which is what lets a
    kernel block hold every live partial in shared memory); the jnp path
    keeps the one-slot-per-internal-node TreeBatch arrays (the downward
    passes in ops/asr.py need every internal partial retained).
    site_logliks dispatches on which keys are present.
    """
    from linearham_tpu.utils.runtime import use_pruning_kernel

    if use_pruning_kernel(dtype):
        from linearham_tpu.io.schedule import build_schedule

        s = build_schedule(tb)
        return {
            "sched_src": s.src,
            "sched_penc": s.penc,
            "sched_len": s.length,
            "sched_root": s.root,
        }, s.n_slots
    return {
        "tip_perm": tb.tip_perm,
        "tip_parent": tb.tip_parent,
        "tip_length": np.asarray(tb.tip_length, np.float64),
        "edge_child": tb.edge_child,
        "edge_parent": tb.edge_parent,
        "edge_length": np.asarray(tb.edge_length, np.float64),
        "root_slot": tb.root_slot,
    }, tb.n_slots


def narrow_index(a: np.ndarray) -> np.ndarray:
    """Index array as int16 when every value fits (xMSA row, slot and
    schedule codes do for any real family), else int32.  Halves the
    dominant transfer bytes of a chunk; site_logliks widens on device."""
    a = np.asarray(a)
    if a.size and a.max() < 2**15 - 1 and a.min() >= -2**15:
        return a.astype(np.int16)
    return a.astype(np.int32)


# Stand-in for -inf while emissions flow through matmuls (0 * -inf = NaN
# would poison the one-hot contractions); exp(_NEG_CAP - anything) == 0 in
# both f32 and f64, and summing a whole region of them stays finite.
_NEG_CAP = -1e30


def _gather_consts(space, xmsa: Xmsa, dtype):
    """HOST-side constants for turning site log-liks into region emissions.

    All index maps are folded into ONE-HOT selection matrices on host so
    the per-step emission assembly is pure matmul ([T, X] @ [X, S]).
    Returned as numpy so the caller can batch the whole family into one
    jax.device_put.
    """
    consts = {}
    X = xmsa.n_cols
    del dtype  # maps store as narrow ints; region_emissions widens

    def linear(name, region, inds):
        # m[x, g] = how many of gene g's sites map to xMSA column x; the
        # per-gene log-emission sum is then site_ll @ m.  Stored int16
        # (counts are bounded by gene length << 2^15): the maps are the
        # bulk of the per-family device bytes, and a repertoire bucket
        # ships one copy per family — narrow storage quarters that wire
        # cost; the matmul operand is cast on device.
        seg = segment_matrix(inds, region.ggene_ranges,
                             len(region.ggene_ranges))
        m = np.zeros((X, seg.shape[1]))
        np.add.at(m, np.asarray(inds, np.intp), seg)
        consts[name] = {"m": m.astype(np.int16)}

    def junction(name, inds):
        # Ship only the [rows, S] xMSA column indices; the one-hot
        # selection matrix the emission matmul contracts against is
        # rebuilt ON DEVICE from an iota comparison (region_emissions).
        # The materialized one-hots were ~90% of a stacked repertoire
        # bucket's wire bytes (~23MB int8 at 32 families) for pure index
        # structure a few KB of int16 encodes.
        it = np.int16 if X < 2**15 - 1 else np.int32
        consts[name] = {
            "inds": np.asarray(inds, it),     # [rows, S]; -1 = dead cell
            "mask": np.asarray(inds >= 0),    # [rows, S]; also carries the
        }                                     # (rows, S) shape for reshape

    linear("vpadding", space.vpadding, xmsa.inds.vpadding)
    linear("vgerm", space.vgerm, xmsa.inds.vgerm)
    junction("vd_junction", xmsa.inds.vd_junction)
    if space.is_heavy:
        linear("dgerm", space.dgerm, xmsa.inds.dgerm)
        junction("dj_junction", xmsa.inds.dj_junction)
    linear("jgerm", space.jgerm, xmsa.inds.jgerm)
    linear("jpadding", space.jpadding, xmsa.inds.jpadding)
    return consts


def region_emissions(site_loglik: jnp.ndarray, consts: dict,
                     heavy: bool) -> Dict[str, jnp.ndarray]:
    """Contract per-site log-likelihoods [T, X] into region emissions.

    Pure matmuls against host-precomputed one-hot maps (see
    _gather_consts); -inf sites are capped first so 0 * -inf never occurs.

    Precision HIGHEST is load-bearing: at a 312-seq family's depth the
    site log-likelihoods are ~-26 each and a germline region sums
    hundreds of them.  A reduced-precision f32 matmul (TF32 on the GPU
    keeps ~10 mantissa bits) random-walks to a per-tree log-likelihood
    error of whole units, directly distorting the softmax importance
    weights the bootstrap consumes.
    """
    emis = {}
    T = site_loglik.shape[0]
    safe = jnp.maximum(site_loglik, _NEG_CAP)
    f = site_loglik.dtype

    def linear(name):
        # Maps ride the wire as narrow ints (see _gather_consts); the
        # cast to the compute dtype fuses into the matmul.
        emis[name] = jnp.matmul(safe, consts[name]["m"].astype(f),
                                precision=jax.lax.Precision.HIGHEST)

    def junction(name):
        c = consts[name]
        X = safe.shape[1]
        flat = jnp.maximum(c["inds"], 0).reshape(1, -1)     # [1, rows*S]
        # One-hot built in-jit (iota == index): the gather as a matmul,
        # without shipping the one-hot to the device.  Dead cells (-1)
        # select column 0 and are masked below.
        oh = (jnp.arange(X, dtype=flat.dtype)[:, None] == flat).astype(f)
        vals = jnp.matmul(
            safe, oh, precision=jax.lax.Precision.HIGHEST,
        ).reshape((T,) + c["mask"].shape)
        emis[name] = jnp.where(c["mask"][None], vals, -jnp.inf)

    linear("vpadding")
    linear("vgerm")
    junction("vd_junction")
    if heavy:
        linear("dgerm")
        junction("dj_junction")
    linear("jgerm")
    linear("jpadding")
    return emis


def site_logliks(
    xmsa_rows: jnp.ndarray,      # [n_rows, X] int codes (naive row 0)
    tree: dict,                  # batched tree encoding (ensemble_encoding)
    eig,                         # GTREigen with [T, ...] leading axis
    pi: jnp.ndarray,             # [T, 4]
    rates: jnp.ndarray,          # [T, R]
    n_slots: int,
) -> jnp.ndarray:
    """Per-site rate-mixed log-likelihoods [T, X] (Felsenstein pruning).

    Slot-reuse schedules run through the GPU kernel, TreeBatch arrays
    through the jnp path; the encoding decides (ensemble_encoding).
    """
    # Topology indices may arrive as int16 (narrow_index); widen once here.
    tree = {
        k: (v.astype(jnp.int32)
            if jnp.issubdtype(v.dtype, jnp.integer) else v)
        for k, v in tree.items()
    }

    if "sched_src" in tree:
        from linearham_tpu.ops.pruning_kernel import (
            site_log_likelihoods_kernel,
        )

        site_ll = site_log_likelihoods_kernel(
            eig, pi, rates, xmsa_rows, tree["sched_src"],
            tree["sched_penc"], tree["sched_len"], tree["sched_root"],
            n_slots=n_slots)
        return site_ll.astype(pi.dtype)

    def per_tree(eig_t, pi_t, rates_t, perm, tparent, tlen, echild,
                 eparent, elen, root):
        tips = xmsa_rows[perm]                # [n_tips, X]
        return site_log_likelihoods(
            eig_t, pi_t, rates_t, tips, tparent, tlen,
            echild, eparent, elen, root, n_slots,
        )

    return jax.vmap(per_tree)(
        eig, pi, rates, tree["tip_perm"], tree["tip_parent"],
        tree["tip_length"], tree["edge_child"], tree["edge_parent"],
        tree["edge_length"], tree["root_slot"],
    )


def emissions_from_site_ll(consts: dict, naive_bases: jnp.ndarray,
                           site_ll: jnp.ndarray, pi: jnp.ndarray,
                           heavy: bool):
    """Naive-prior correction + emission contractions.

    Returns (emission dict for the forward pass, corrected site log-liks
    [T, X]).
    """
    # Divide out the naive prior at unambiguous naive sites, as a
    # [T,4] @ [4,X] one-hot matmul.
    naive_oh = (jnp.arange(4)[:, None]
                == jnp.minimum(naive_bases, 3)[None, :])
    naive_oh = (naive_oh & (naive_bases[None, :] < 4)).astype(site_ll.dtype)
    site_ll_corr = site_ll - jnp.matmul(
        jnp.log(pi), naive_oh, precision=jax.lax.Precision.HIGHEST)
    return region_emissions(site_ll_corr, consts, heavy), site_ll_corr


def phylo_emissions(
    consts: dict,
    xmsa_rows: jnp.ndarray,      # [n_rows, X] int codes (naive row 0)
    naive_bases: jnp.ndarray,    # [X]
    tree: dict,                  # batched tree encoding as jnp
    eig,                         # GTREigen with [T, ...] leading axis
    pi: jnp.ndarray,             # [T, 4]
    rates: jnp.ndarray,          # [T, R]
    heavy: bool,
    n_slots: int,
):
    """Pruning + naive-prior correction + emission gathers.

    Returns (emission dict for the forward pass, corrected site log-liks
    [T, X]).
    """
    site_ll = site_logliks(xmsa_rows, tree, eig, pi, rates, n_slots)
    return emissions_from_site_ll(consts, naive_bases, site_ll, pi, heavy)


def step_from_site_ll(trans, consts, naive_bases, site_ll, pi, key,
                      heavy: bool):
    """phylo_step after pruning: (loglik [T], xMSA emission [T, X],
    sampled path or None)."""
    emis, site_ll_corr = emissions_from_site_ll(
        consts, naive_bases, site_ll, pi, heavy)
    loglik, cache = forward(trans, emis, heavy)
    path = sample_path(key, trans, cache, heavy) if key is not None else None
    return loglik, jnp.exp(site_ll_corr), path


def phylo_step(
    trans: Dict[str, jnp.ndarray],
    consts: dict,
    xmsa_rows: jnp.ndarray,
    naive_bases: jnp.ndarray,
    tree: dict,
    eig,
    pi: jnp.ndarray,
    rates: jnp.ndarray,
    key: Optional[jnp.ndarray],
    heavy: bool,
    n_slots: int,
):
    """One fused pipeline step over a tree batch.

    Returns (loglik [T], xmsa emission [T, X], sampled path or None).
    """
    site_ll = site_logliks(xmsa_rows, tree, eig, pi, rates, n_slots)
    return step_from_site_ll(trans, consts, naive_bases, site_ll, pi, key,
                             heavy)


def phylo_map_step(
    trans: Dict[str, jnp.ndarray],
    consts: dict,
    xmsa_rows: jnp.ndarray,
    naive_bases: jnp.ndarray,
    tree: dict,
    eig,
    pi: jnp.ndarray,
    rates: jnp.ndarray,
    heavy: bool,
    n_slots: int,
):
    """Viterbi variant: returns (MAP joint log-prob [T], MAP path)."""
    from linearham_tpu.ops.viterbi import viterbi

    emis, _ = phylo_emissions(
        consts, xmsa_rows, naive_bases, tree, eig, pi, rates, heavy,
        n_slots)
    return viterbi(trans, emis, heavy)


def phylo_step_packed(
    trans, consts, xmsa_rows, naive_bases, tree, eig, pi, rates, key,
    heavy: bool, n_slots: int,
):
    """phylo_step with the log-likelihoods and sampled path packed into
    ONE int array (see pack_step): one host read drains a chunk.  The
    unused xMSA emission output is dropped so XLA eliminates it."""
    loglik, _, path = phylo_step(
        trans, consts, xmsa_rows, naive_bases, tree, eig, pi, rates, key,
        heavy=heavy, n_slots=n_slots)
    return pack_step(trans, loglik, path, heavy)


def pack_step(trans, loglik, path: SampledPath, heavy: bool):
    """Pack per-tree outputs into one int array [T, C].

    Layout: [loglik bits, vgerm, (dgerm,) jgerm, vd_rows..., (dj_rows...)];
    ``unpack_path`` reverses it host-side.  The leading columns carry the
    log-likelihood bit-cast into the int width (full precision kept).
    Path indices are state indices within a region — O(genes x
    junction-window) — so int16 fits any real family; the trace-time shape
    guard falls back to int32 for pathological state spaces, and
    unpack_path infers the layout from the array dtype.
    """
    T = loglik.shape[0]
    max_states = max(
        trans["vd"].shape[-1],
        trans["dj"].shape[-1] if heavy else 0,
        trans["vgerm_static_log"].shape[-1],
        trans["jpadding_log"].shape[-1],
    )
    wire = jnp.int16 if max_states < 2**15 - 1 else jnp.int32
    ll_bits = jax.lax.bitcast_convert_type(
        loglik[:, None], wire).reshape(T, -1)
    head = [ll_bits, path.vgerm_idx[:, None]]
    if heavy:
        head.append(path.dgerm_idx[:, None])
    head.append(path.jgerm_idx[:, None])
    tail = [path.vd_idx] + ([path.dj_idx] if heavy else [])
    return jnp.concatenate(
        [jnp.asarray(c, wire) for c in head + tail], axis=1)


def unpack_path(packed: np.ndarray, heavy: bool, r1: int,
                f64: bool = False):
    """Host-side inverse of phylo_step_packed's layout.

    The wire int width (int16 normally, int32 for huge state spaces) is
    inferred from ``packed.dtype``.  Returns (loglik [T] in the step's
    float width, SampledPath of int index arrays).
    """
    ll_width = 8 if f64 else 4
    k = ll_width // packed.dtype.itemsize
    ftype = np.float64 if f64 else np.float32
    loglik = np.ascontiguousarray(packed[:, :k]).view(ftype).ravel()
    loglik = loglik.astype(np.float64)
    body = packed[:, k:]
    if heavy:
        path = SampledPath(
            vgerm_idx=body[:, 0],
            dgerm_idx=body[:, 1],
            jgerm_idx=body[:, 2],
            vd_idx=body[:, 3:3 + r1],
            dj_idx=body[:, 3 + r1:],
        )
    else:
        path = SampledPath(
            vgerm_idx=body[:, 0],
            dgerm_idx=None,
            jgerm_idx=body[:, 1],
            vd_idx=body[:, 2:2 + r1],
            dj_idx=None,
        )
    return loglik, path


# Module-level jits: per-call jax.jit wrappers would retrace on every
# invocation (the reference's --sample explicitly caches its forward pass,
# src/linearham.cpp:384-386); hoisting shares the trace cache process-wide.
phylo_step_jit = jax.jit(phylo_step, static_argnames=("heavy", "n_slots"))
phylo_step_packed_jit = jax.jit(
    phylo_step_packed, static_argnames=("heavy", "n_slots"))
phylo_emissions_jit = jax.jit(
    phylo_emissions, static_argnames=("heavy", "n_slots"))
forward_jit = jax.jit(forward, static_argnames=("heavy",))
phylo_map_step_jit = jax.jit(
    phylo_map_step, static_argnames=("heavy", "n_slots"))


@dataclass
class PhyloParams:
    er: List[float]
    pi: List[float]
    alpha: float
    num_rates: int
    rates: np.ndarray


class PhyloHMM:
    """Phylo-HMM over one clonal family."""

    def __init__(self, yaml_path: str, cluster_ind: int,
                 hmm_param_dir: str, seed: int = 0, dtype=None):
        cluster = load_cluster(yaml_path, cluster_ind)
        genes = load_gene_map(hmm_param_dir)
        self._setup(cluster, genes,
                    cluster.msa_codes(
                        next(iter(genes.values())).alphabet + "N"),
                    seed, dtype)

    @classmethod
    def from_parts(cls, locus, flexbounds, relpos, genes, msa, unique_ids,
                   n_sites, seed: int = 0, dtype=None) -> "PhyloHMM":
        """Build directly from in-memory data (synthetic families, tests)."""
        self = cls.__new__(cls)
        cluster = ClusterData(
            locus=locus, unique_ids=list(unique_ids),
            naive_seq="N" * n_sites,
            seqs=[], flexbounds=dict(flexbounds), relpos=dict(relpos),
            raw_event={},
        )
        self._setup(cluster, genes, msa, seed, dtype)
        return self

    def _setup(self, cluster: ClusterData, genes, msa: np.ndarray,
               seed: int, dtype) -> None:
        if dtype is None:
            from linearham_tpu.utils.runtime import resolve_dtype

            dtype = resolve_dtype(None)
        self._install(
            self._host_products(cluster, genes, msa, dtype), seed, dtype)

    @staticmethod
    def _host_products(cluster: ClusterData, genes, msa: np.ndarray,
                       dtype) -> dict:
        """All family-constant host tensors: the (picklable) unit the
        family disk cache stores (compiler/family_cache.py)."""
        space = build_state_space(
            cluster.locus, cluster.flexbounds, cluster.relpos, genes,
        )
        family = compile_family(space, genes)
        xmsa = build_xmsa(space, msa, cluster.unique_ids)
        return {
            "cluster": cluster,
            "genes": genes,
            "space": space,
            "family": family,
            "msa": msa,
            "xmsa": xmsa,
            "trans_np": family.host_transitions(
                np.dtype(jnp.dtype(dtype).name)),
            "consts_np": _gather_consts(space, xmsa, dtype),
            "xmsa_rows_np": np.asarray(xmsa.matrix, np.int32),
            "naive_bases_np": np.asarray(xmsa.naive_bases, np.int32),
        }

    def _install(self, host: dict, seed: int, dtype,
                 place: bool = True) -> None:
        self.cluster = host["cluster"]
        self.genes = host["genes"]
        self.space = host["space"]
        self.family: CompiledFamily = host["family"]
        self.msa = host["msa"]
        self.xmsa: Xmsa = host["xmsa"]
        self._dtype = dtype
        self._key = jax.random.PRNGKey(seed)

        self._trans_np = host["trans_np"]
        self._consts_np = host["consts_np"]
        self._xmsa_rows_np = host["xmsa_rows_np"]
        self._naive_bases_np = host["naive_bases_np"]
        self._placed = False
        # place() may be called concurrently (the pipeline warms the
        # family-constant transfer on a side thread while the main thread
        # stages chunk 0); the lock makes the one packed put happen once.
        import threading

        self._place_lock = threading.Lock()
        if place:
            self.place()

        self.params: Optional[PhyloParams] = None
        self._tree_batch: Optional[TreeBatch] = None
        self._loglik = None
        self._cache = None
        self._xmsa_emission = None

    def place(self) -> "PhyloHMM":
        """Put the family-constant tensors on device (idempotent), in one
        batched device_put.  Deferred placement (``place=False`` at
        construction) lets repertoire tasks skip placement entirely —
        bucket stacking reads the host copies only.
        """
        with self._place_lock:
            if not self._placed:
                from linearham_tpu.utils.wire import device_put_packed

                (self._trans, self._consts, self._xmsa_rows,
                 self._naive_bases) = device_put_packed(
                    (self._trans_np, self._consts_np, self._xmsa_rows_np,
                     self._naive_bases_np))
                self._placed = True
        return self

    # -- single-tree API (mirrors the reference CLI subcommands) ----------

    def init_phylo_parameters(self, newick_path: str, er: Sequence[float],
                              pi: Sequence[float], alpha: float,
                              num_rates: int) -> None:
        with open(newick_path) as fh:
            text = fh.read()
        tree = parse_newick(text)
        self._tree_batch = batch_trees([tree], self.xmsa.labels)
        self.params = PhyloParams(
            er=list(er), pi=list(pi), alpha=float(alpha),
            num_rates=num_rates,
            rates=gamma_category_rates(float(alpha), num_rates),
        )
        self._loglik = None

    def init_phylo_emission(self) -> None:
        self._run(sample_key=None)

    def _host_tree(self, tb: TreeBatch):
        """Wire-ready host copies of a tree batch: (arrays dict, n_slots).

        Encoding follows ensemble_encoding; floats take the compute dtype
        and indices go through narrow_index."""
        enc, n_slots = ensemble_encoding(tb, self._dtype)
        return self._wire_tree(enc), n_slots

    def _wire_tree(self, enc: dict) -> dict:
        f = np.dtype(jnp.dtype(self._dtype).name)
        return {k: (np.asarray(v, f)
                    if np.issubdtype(np.asarray(v).dtype, np.floating)
                    else narrow_index(v))
                for k, v in enc.items()}

    def _device_tree(self, tb: TreeBatch):
        from linearham_tpu.utils.wire import device_put_packed

        host, n_slots = self._host_tree(tb)
        return device_put_packed(host), n_slots

    def _ensemble_inputs(self):
        """Replicated GTR/rate inputs for the current single-tree batch."""
        self.place()
        p = self.params
        tb = self._tree_batch
        T = tb.n_trees
        pi = jnp.asarray([p.pi] * T, self._dtype)
        rates = jnp.asarray([p.rates] * T, self._dtype)
        eig = gtr_eigen([p.er] * T, [p.pi] * T)
        tree, n_slots = self._device_tree(tb)
        return tree, eig, pi, rates, n_slots

    def _run(self, sample_key):
        tree, eig, pi, rates, n_slots = self._ensemble_inputs()

        loglik, xmsa_emission, path = phylo_step_jit(
            self._trans, self._consts, self._xmsa_rows, self._naive_bases,
            tree, eig, pi, rates, sample_key,
            heavy=self.space.is_heavy, n_slots=n_slots,
        )
        self._loglik = np.asarray(loglik)
        self._xmsa_emission = np.asarray(xmsa_emission)
        return path

    def log_likelihood(self) -> float:
        if self._loglik is None:
            self._run(sample_key=None)
        return float(self._loglik[0])

    @property
    def xmsa_emission(self) -> np.ndarray:
        if self._xmsa_emission is None:
            self._run(sample_key=None)
        return self._xmsa_emission[0]

    def sample_naive_sequence(self) -> Annotation:
        self._key, subkey = jax.random.split(self._key)
        path = self._run(sample_key=subkey)
        return self._decode(path, 0)

    def sample_annotations(self, n: int) -> List[Annotation]:
        """Draw ``n`` posterior paths in one batched device call.

        Emissions and the forward pass run once; samples are ``n``
        vmapped FFBS backward walks (the reference's --sample subcommand
        likewise caches the forward pass, src/linearham.cpp:384-386).
        """
        tree, eig, pi, rates, n_slots = self._ensemble_inputs()
        heavy = self.space.is_heavy

        emis, site_ll = phylo_emissions_jit(
            self._consts, self._xmsa_rows, self._naive_bases,
            tree, eig, pi, rates,
            heavy=heavy, n_slots=n_slots,
        )
        loglik, cache = forward_jit(self._trans, emis, heavy=heavy)
        self._loglik = np.asarray(loglik)
        self._xmsa_emission = np.asarray(jnp.exp(site_ll))

        self._key, subkey = jax.random.split(self._key)
        keys = jax.random.split(subkey, n)
        paths = jax.tree.map(
            np.asarray,
            sample_paths_batch(keys, self._trans, cache, heavy))
        return self._decode_batch(jax.tree.map(lambda a: a[:, 0], paths))

    def map_annotation(self) -> Annotation:
        """The MAP (Viterbi) V(D)J annotation under the current tree."""
        tree, eig, pi, rates, n_slots = self._ensemble_inputs()
        score, path = phylo_map_step_jit(
            self._trans, self._consts, self._xmsa_rows, self._naive_bases,
            tree, eig, pi, rates,
            heavy=self.space.is_heavy, n_slots=n_slots,
        )
        self.map_score = float(np.asarray(score)[0])
        return self._decode(jax.tree.map(np.asarray, path), 0)

    def _decode_batch(self, path: SampledPath) -> List[Annotation]:
        """Decode a whole batch of sampled paths (leaves are numpy [T,...])
        with one vectorized pass; see models.decode.decode_paths_batch."""
        heavy = self.space.is_heavy
        return decode_paths_batch(
            self.space,
            vgerm_idx=path.vgerm_idx,
            vd_idx=path.vd_idx,
            dgerm_idx=path.dgerm_idx if heavy else None,
            dj_idx=path.dj_idx if heavy else None,
            jgerm_idx=path.jgerm_idx,
            n_sites=self.cluster.n_sites,
        )

    def _decode(self, path: SampledPath, t: int) -> Annotation:
        heavy = self.space.is_heavy
        return decode_path(
            self.space,
            vgerm_idx=int(path.vgerm_idx[t]),
            vd_idx=np.asarray(path.vd_idx[t]),
            dgerm_idx=int(path.dgerm_idx[t]) if heavy else None,
            dj_idx=np.asarray(path.dj_idx[t]) if heavy else None,
            jgerm_idx=int(path.jgerm_idx[t]),
            n_sites=self.cluster.n_sites,
        )
