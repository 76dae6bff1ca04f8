"""Warm-start caches: compiled-family disk cache + executable cache.

The reference is an AOT C++ binary with zero startup compilation
(src/linearham.cpp:268); these caches are what make a warm process start
comparable (VERDICT r03 item 1).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linearham_tpu.compiler.family_cache import cached_phylo_hmm, family_key
from linearham_tpu.models.phylo_hmm import PhyloHMM


@pytest.fixture
def family_files(fixtures_dir):
    return str(fixtures_dir / "phylo_hmm_input.yaml"), \
        str(fixtures_dir / "hmm_params")


def test_family_cache_roundtrip(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    cache = str(tmp_path / "fam_cache")

    fresh = PhyloHMM(yaml_path, 0, gene_dir, seed=0)
    first = cached_phylo_hmm(yaml_path, 0, gene_dir, seed=0,
                             cache_dir=cache)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].endswith(".pkl")
    second = cached_phylo_hmm(yaml_path, 0, gene_dir, seed=0,
                              cache_dir=cache)

    # The cached instance must be indistinguishable: same state space,
    # same device constants, same xMSA.
    for hmm in (first, second):
        assert hmm.space.is_heavy == fresh.space.is_heavy
        np.testing.assert_array_equal(hmm._xmsa_rows_np,
                                      fresh._xmsa_rows_np)
        np.testing.assert_array_equal(hmm._naive_bases_np,
                                      fresh._naive_bases_np)
        for k in fresh._trans_np:
            np.testing.assert_array_equal(hmm._trans_np[k],
                                          fresh._trans_np[k])


def test_family_cache_loglik_parity(family_files, fixtures_dir, tmp_path):
    yaml_path, gene_dir = family_files
    cache = str(tmp_path / "fam_cache")
    newick = str(fixtures_dir / "newton.tree")
    kw = dict(er=[1.0] * 6, pi=[0.17, 0.19, 0.25, 0.39], alpha=1.0,
              num_rates=4)

    cached_phylo_hmm(yaml_path, 0, gene_dir, cache_dir=cache)  # populate
    hmm = cached_phylo_hmm(yaml_path, 0, gene_dir, cache_dir=cache)  # hit
    hmm.init_phylo_parameters(newick, **kw)
    ref = PhyloHMM(yaml_path, 0, gene_dir)
    ref.init_phylo_parameters(newick, **kw)
    assert hmm.log_likelihood() == pytest.approx(ref.log_likelihood(),
                                                 rel=1e-12)


def test_family_cache_key_tracks_input_content(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    import shutil

    k1 = family_key(yaml_path, 0, gene_dir, "float64")
    assert k1 == family_key(yaml_path, 0, gene_dir, "float64")
    assert k1 != family_key(yaml_path, 1, gene_dir, "float64")
    assert k1 != family_key(yaml_path, 0, gene_dir, "float32")

    # A single changed byte in any gene YAML must change the key.
    alt = tmp_path / "hmm_params"
    shutil.copytree(gene_dir, alt)
    victim = sorted(p for p in alt.iterdir() if p.suffix == ".yaml")[0]
    victim.write_text(victim.read_text() + "\n# changed\n")
    assert k1 != family_key(yaml_path, 0, str(alt), "float64")


def test_family_cache_corrupt_entry_falls_back(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    cache = tmp_path / "fam_cache"
    cache.mkdir()
    key = family_key(yaml_path, 0, gene_dir, "float64")
    bad = cache / (key + ".pkl")
    bad.write_bytes(b"not a pickle")
    hmm = cached_phylo_hmm(yaml_path, 0, gene_dir, cache_dir=str(cache))
    assert hmm.space is not None
    # The corrupt entry was replaced by a fresh one.
    assert bad.read_bytes() != b"not a pickle"


def _wait_for(pred, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class _CountingJit:
    """Proxy that counts how often the jit path is taken (vs the
    deserialized-executable path, which never touches the jit fn)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)

    def lower(self, *a, **k):
        return self.fn.lower(*a, **k)


def test_exec_cache_hit_skips_jit(tmp_path, monkeypatch):
    from linearham_tpu.utils import exec_cache

    monkeypatch.setenv("LINEARHAM_EXEC_CACHE",
                       "force:" + str(tmp_path / "exec"))

    @jax.jit
    def f(x, y):
        return x * 2.0 + y.sum()

    proxy = _CountingJit(f)
    x = jnp.arange(8, dtype=jnp.float32)
    y = jnp.ones((4,), jnp.float32)
    out1 = exec_cache.cached_call(proxy, "test_fn", {}, x, y)
    assert proxy.calls == 1
    # Population happens in a background thread; wait for the entry.
    d = tmp_path / "exec"
    assert _wait_for(
        lambda: d.is_dir() and any(p.endswith(".pkl")
                                   for p in os.listdir(d)))

    # Simulate a fresh process: drop the in-memory handle; the second
    # call must come from the deserialized executable, not the jit path.
    exec_cache._MEM.clear()
    out2 = exec_cache.cached_call(proxy, "test_fn", {}, x, y)
    assert proxy.calls == 1
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2))


def test_exec_cache_key_separates_shapes_and_statics(tmp_path, monkeypatch):
    from linearham_tpu.utils import exec_cache

    monkeypatch.setenv("LINEARHAM_EXEC_CACHE",
                       "force:" + str(tmp_path / "exec"))

    def g(x, n):
        return x + n

    jg = jax.jit(g, static_argnames=("n",))
    a = jnp.ones((4,), jnp.float32)
    b = jnp.ones((8,), jnp.float32)
    s1 = exec_cache._signature("g", {"n": 1}, (a,))
    assert s1 == exec_cache._signature("g", {"n": 1}, (a,))
    assert s1 != exec_cache._signature("g", {"n": 2}, (a,))
    assert s1 != exec_cache._signature("g", {"n": 1}, (b,))
    assert s1 != exec_cache._signature("other", {"n": 1}, (a,))

    out = exec_cache.cached_call(jg, "g", {"n": 3}, a)
    np.testing.assert_allclose(np.asarray(out), 4.0)


def test_exec_cache_corrupt_entry_recovers(tmp_path, monkeypatch):
    from linearham_tpu.utils import exec_cache

    d = tmp_path / "exec"
    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "force:" + str(d))

    @jax.jit
    def f(x):
        return x - 1.0

    x = jnp.full((3,), 5.0, jnp.float32)
    key = exec_cache._signature("corrupt", {}, (x,))
    d.mkdir()
    (d / (key + ".pkl")).write_bytes(b"garbage")
    out = exec_cache.cached_call(f, "corrupt", {}, x)
    np.testing.assert_allclose(np.asarray(out), 4.0)
    # Bad entry removed (and possibly repopulated by the background
    # thread with a valid one).
    data = None
    if (d / (key + ".pkl")).exists():
        data = (d / (key + ".pkl")).read_bytes()
        assert data != b"garbage"


def test_exec_cache_off_env(monkeypatch):
    from linearham_tpu.utils import exec_cache

    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "off")

    @jax.jit
    def f(x):
        return x * 3.0

    out = exec_cache.cached_call(f, "off_test", {},
                                 jnp.ones((2,), jnp.float32))
    np.testing.assert_allclose(np.asarray(out), 3.0)


@pytest.mark.gpu
def test_exec_cache_hit_bitwise_identical_on_gpu(gpu, tmp_path, monkeypatch):
    """On the production backend, the deserialized-executable path must
    produce byte-identical packed results to the jit path (the disk
    round trip replaces trace/lower/compile, not the program).  The f32
    step carries the pruning kernel's custom call."""
    from linearham_tpu.models.phylo_hmm import phylo_step_packed_jit
    from linearham_tpu.pipeline.run import prepare_ensemble
    from linearham_tpu.utils import exec_cache
    from linearham_tpu.utils.synth import make_family, make_tree_samples

    monkeypatch.setenv("LINEARHAM_EXEC_CACHE",
                       "force:" + str(tmp_path / "exec"))
    fam = make_family(n_seqs=6, seed=3)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, seed=0, dtype=jnp.float32,
    ).place()
    samples = make_tree_samples(fam, 8, seed=3)
    tree_arrays, eig, rates, n_slots = prepare_ensemble(hmm, samples, 4)
    assert "sched_src" in tree_arrays       # the kernel's encoding

    def to_dev(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float32) \
            if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a)

    tree = {k: to_dev(v) for k, v in tree_arrays.items()}
    args = (hmm._trans, hmm._consts, hmm._xmsa_rows, hmm._naive_bases,
            tree, jax.tree.map(to_dev, eig), to_dev(samples.pi),
            to_dev(rates), jax.random.PRNGKey(7))
    statics = dict(heavy=True, n_slots=n_slots)

    jit_out = np.asarray(phylo_step_packed_jit(*args, **statics))
    exec_cache.cached_call(phylo_step_packed_jit, "gpu_parity", statics,
                           *args)
    assert exec_cache.flush(timeout=120.0)
    exec_cache._MEM.clear()
    cached_out = np.asarray(exec_cache.cached_call(
        phylo_step_packed_jit, "gpu_parity", statics, *args))
    np.testing.assert_array_equal(jit_out, cached_out)


def test_exec_cache_default_follows_platform_policy(monkeypatch, tmp_path):
    """Unset, the exec cache is off on the CPU and on under the cache root
    on the GPU."""
    from linearham_tpu.utils import exec_cache, runtime

    monkeypatch.delenv("LINEARHAM_EXEC_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert exec_cache._cache_dir() is None           # CPU: off
    monkeypatch.setattr(runtime, "platform_policy",
                        lambda p=None: runtime._POLICIES["gpu"])
    assert exec_cache._cache_dir() == str(tmp_path / "exec")


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_cache_placement(env_set, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory
    of its own (JAX reads the variable); unset, the cache goes to the
    fixed path inside the checkout."""
    from linearham_tpu.utils import runtime

    old_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    sentinel = str(tmp_path / "unchanged")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "jaxcache"))
            assert runtime.enable_persistent_cache() == str(
                tmp_path / "jaxcache")
            assert jax.config.jax_compilation_cache_dir == sentinel
            assert runtime.cache_root() == str(tmp_path / "jaxcache")
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(runtime.CHECKOUT_CACHE_DIR, "jax")
            assert runtime.enable_persistent_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
            assert os.path.isdir(want)
            assert runtime.cache_root() == runtime.CHECKOUT_CACHE_DIR
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert runtime.CHECKOUT_CACHE_DIR == os.path.join(repo, ".cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)


def test_exec_cache_prunes_stale_entries(tmp_path, monkeypatch):
    """Storing a new entry removes .pkl files untouched for the prune
    window (entries strand whenever the source hash changes)."""
    from linearham_tpu.utils import exec_cache

    d = tmp_path / "exec"
    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "force:" + str(d))
    d.mkdir()
    stale = d / "deadbeef.pkl"
    stale.write_bytes(b"old")
    old = time.time() - (exec_cache._PRUNE_AGE_DAYS + 1) * 86400
    os.utime(stale, (old, old))
    fresh = d / "cafef00d.pkl"
    fresh.write_bytes(b"recent")

    @jax.jit
    def f(x):
        return x + 2.0

    x = jnp.ones((4,), jnp.float32)
    exec_cache.cached_call(f, "prune_test", {}, x)
    assert _wait_for(lambda: not stale.exists())
    assert fresh.exists()   # recent entries survive


def test_exec_cache_flush_joins_persist(tmp_path, monkeypatch):
    """flush() must not return success until the background persist has
    landed the entry (ADVICE r04: a short-lived warmup process exiting
    early leaves the cache silently cold)."""
    from linearham_tpu.utils import exec_cache

    d = tmp_path / "exec"
    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "force:" + str(d))

    @jax.jit
    def f(x):
        return x * 5.0

    x = jnp.ones((6,), jnp.float32)
    exec_cache.cached_call(f, "flush_test", {}, x)
    assert exec_cache.flush(timeout=60.0)
    # After a successful flush the entry is on disk NOW, no waiting.
    assert d.is_dir() and any(p.endswith(".pkl") for p in os.listdir(d))
    with exec_cache._LOCK:
        assert not any(t.is_alive() for t in exec_cache._INFLIGHT.values())


def test_exec_cache_runtime_failure_keeps_entry(tmp_path, monkeypatch):
    """A loaded executable that fails at RUN time must poison only the
    in-memory handle; the on-disk entry survives for later processes
    (ADVICE r04: transient device errors must not evict valid entries)."""
    from linearham_tpu.utils import exec_cache

    d = tmp_path / "exec"
    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "force:" + str(d))

    @jax.jit
    def f(x):
        return x + 7.0

    x = jnp.ones((5,), jnp.float32)
    out1 = exec_cache.cached_call(f, "runtime_fail", {}, x)
    assert exec_cache.flush(timeout=60.0)
    entry = next(d / p for p in os.listdir(d) if p.endswith(".pkl"))
    blob = entry.read_bytes()

    class _Boom:
        def __call__(self, *a):
            raise RuntimeError("transient device error")

    exec_cache._MEM.clear()
    path = str(entry)
    exec_cache._MEM[path] = _Boom()   # simulate loaded-but-failing exec
    out2 = exec_cache.cached_call(f, "runtime_fail", {}, x)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2))
    assert entry.exists() and entry.read_bytes() == blob  # NOT evicted
    assert exec_cache._MEM[path] is exec_cache._POISONED


def test_exec_cache_prunes_stale_partials(tmp_path, monkeypatch):
    """Stranded .partial temp files (writer killed at interpreter exit)
    are cleaned up by the prune pass alongside stale .pkl entries."""
    from linearham_tpu.utils import exec_cache

    d = tmp_path / "exec"
    monkeypatch.setenv("LINEARHAM_EXEC_CACHE", "force:" + str(d))
    d.mkdir()
    dead = d / "tmpabc123.partial"
    dead.write_bytes(b"half-written")
    old = time.time() - 7200
    os.utime(dead, (old, old))
    live = d / "tmpdef456.partial"   # a concurrent writer's fresh temp
    live.write_bytes(b"in progress")

    @jax.jit
    def f(x):
        return x - 3.0

    exec_cache.cached_call(f, "partial_prune", {},
                           jnp.ones((4,), jnp.float32))
    assert _wait_for(lambda: not dead.exists())
    assert live.exists()


def test_exec_cache_signature_includes_jaxlib(monkeypatch):
    """The cache key must track the jaxlib runtime version, not just
    jax's (ADVICE r04: a jaxlib-only upgrade must miss, not deserialize
    an executable built against a different runtime)."""
    from linearham_tpu.utils import exec_cache

    x = jnp.ones((3,), jnp.float32)
    s1 = exec_cache._signature("v", {}, (x,))
    real = exec_cache._jaxlib_version()
    assert real not in ("", "unknown")
    monkeypatch.setattr(exec_cache, "_jaxlib_version", lambda: real + ".post1")
    assert exec_cache._signature("v", {}, (x,)) != s1
