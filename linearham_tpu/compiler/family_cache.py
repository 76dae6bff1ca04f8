"""Disk cache of compiled clonal families.

``PhyloHMM.__init__`` runs the whole host-side "family compile" — partis
YAML parse, germline gene map parse, state-space construction, transition
tensors, xMSA build, one-hot emission-assembly constants — from scratch
every process (the reference pays the same cost per `linearham` invocation,
src/HMM.cpp:27-190, but in C++ it is milliseconds; in Python the YAML
parsing alone is ~1 s and the whole build 2-13 s under host contention,
BENCH_r03).  Production pipelines re-run the same family many times
(per-chunk-size reruns, workflow resume, repeated sampling), so the
compiled family is cached on disk keyed by a content hash of every input:
the partis YAML bytes, every gene YAML's bytes, the cluster index, the
dtype, and the package source hash.  A warm load is one unpickle +
one batched device_put (~0.3 s vs 2-13 s).

The cache lives under ``utils.runtime.cache_root()``.  Set
LINEARHAM_FAMILY_CACHE=off to disable, or to a directory to relocate.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

from linearham_tpu.utils.fileio import atomic_write

_FORMAT_VERSION = 1

def _cache_dir() -> Optional[str]:
    from linearham_tpu.utils.runtime import cache_root

    d = os.environ.get("LINEARHAM_FAMILY_CACHE") or os.path.join(
        cache_root(), "family")
    return None if d == "off" else d


def family_key(yaml_path: str, cluster_ind: int, hmm_param_dir: str,
               dtype_name: str) -> str:
    """Content hash of every input that determines the compiled family."""
    from linearham_tpu.utils.exec_cache import source_hash

    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION}|{cluster_ind}|{dtype_name}|"
             f"{source_hash()}|".encode())
    with open(yaml_path, "rb") as fh:
        h.update(fh.read())
    for fn in sorted(os.listdir(hmm_param_dir)):
        if fn.endswith((".yaml", ".yml")):
            h.update(fn.encode())
            with open(os.path.join(hmm_param_dir, fn), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:24]


def cached_phylo_hmm(yaml_path: str, cluster_ind: int, hmm_param_dir: str,
                     seed: int = 0, dtype=None,
                     cache_dir: Optional[str] = None,
                     place: bool = True):
    """PhyloHMM constructor through the family disk cache.

    Hit: unpickle host products, device_put, done.  Miss: normal build,
    then persist the host products (atomic rename; concurrent builders
    race benignly).  Any cache failure falls back to a fresh build.

    ``place=False`` defers the device placement (call ``hmm.place()``
    before any device computation); repertoire tasks never need it.
    """
    import jax.numpy as jnp

    from linearham_tpu.models.phylo_hmm import PhyloHMM
    from linearham_tpu.utils.runtime import resolve_dtype

    from linearham_tpu.io.germline import load_gene_map
    from linearham_tpu.io.partis import load_cluster

    if dtype is None:
        dtype = resolve_dtype(None)

    def fresh_build():
        cluster = load_cluster(yaml_path, cluster_ind)
        genes = load_gene_map(hmm_param_dir)
        msa = cluster.msa_codes(next(iter(genes.values())).alphabet + "N")
        host = PhyloHMM._host_products(cluster, genes, msa, dtype)
        hmm = PhyloHMM.__new__(PhyloHMM)
        hmm._install(host, seed, dtype, place=place)
        return hmm, host

    d = cache_dir or _cache_dir()
    if d is None:
        return fresh_build()[0]
    path = os.path.join(
        d, family_key(yaml_path, cluster_ind, hmm_param_dir,
                      jnp.dtype(dtype).name) + ".pkl")
    if os.path.exists(path):
        host = None
        try:
            with open(path, "rb") as fh:
                host = pickle.load(fh)
        except Exception:
            # Only an unreadable pickle means a corrupt entry; failures
            # past this point (e.g. a flaky device_put during _install)
            # must NOT delete a valid cache file.
            try:
                os.unlink(path)
            except OSError:
                pass
        if host is not None:
            hmm = PhyloHMM.__new__(PhyloHMM)
            hmm._install(host, seed, dtype, place=place)
            return hmm
    hmm, host = fresh_build()
    try:
        with atomic_write(path, "wb") as fh:
            pickle.dump(host, fh)
    except Exception:
        pass  # cache population is best-effort
    return hmm
