"""On-disk cache of serialized XLA executables for warm process starts.

JAX's persistent compilation cache removes the XLA *compile* from a warm
start, but a fresh process still pays Python tracing + StableHLO lowering
before the cache can even be consulted.  The reference is an ahead-of-time
C++ binary with zero startup compilation (src/linearham.cpp:268), so the
honest end-to-end unit eats the whole cost.  This cache closes the gap:
after a jit function compiles, its executable is serialized
(jax.experimental.serialize_executable) to disk keyed by the call
signature; a later process deserializes and calls it directly — no trace,
no lower, no compile.

Safety: the key includes the package source hash, jax/jaxlib versions,
device kind+platform, every leaf aval, the arg treedef, and the static
kwargs; any mismatch falls back to the ordinary jit path, and a corrupt
entry is deleted and recompiled.  Set LINEARHAM_EXEC_CACHE=off to
disable.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import pickle
import threading
from typing import Callable, Dict, Optional

_MEM: Dict[str, Callable] = {}
_POISONED = object()   # entry loaded but unrunnable in this process
_INFLIGHT: Dict[str, threading.Thread] = {}  # path -> running persist thread
_LOCK = threading.Lock()
_SRC_HASH: Optional[str] = None
_ATEXIT = False   # flush registered with atexit


def _default_dir() -> str:
    from linearham_tpu.utils.runtime import cache_root

    return os.path.join(cache_root(), "exec")


def _cache_dir() -> Optional[str]:
    """Resolve the cache directory, or None when the cache is disabled.

    Policy: by DEFAULT the cache engages only on the GPU, the production
    platform, under ``utils.runtime.cache_root()``.  XLA:CPU AOT
    deserialization is NOT reliable (observed: a CPU executable stored by
    an 8-device client failed at *async execution* time in a 1-device
    process — too late for the synchronous fallback to catch).  Explicitly
    setting LINEARHAM_EXEC_CACHE=<dir> (or =force / =force:<dir>) is an
    opt-in on ANY backend — a deliberately-set directory must not be
    silently ignored; =off disables everywhere.
    """
    d = os.environ.get("LINEARHAM_EXEC_CACHE")
    if d == "off":
        return None
    if d == "force":
        return _default_dir()
    if d is not None:
        return d[len("force:"):] if d.startswith("force:") else d
    from linearham_tpu.utils.runtime import platform_policy

    return _default_dir() if platform_policy().platform == "gpu" else None


def source_hash() -> str:
    """Hash of every .py file in the package: a code change must never
    resurrect an executable compiled from old code."""
    global _SRC_HASH
    if _SRC_HASH is not None:
        return _SRC_HASH
    import linearham_tpu

    root = os.path.dirname(os.path.abspath(linearham_tpu.__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                h.update(os.path.relpath(p, root).encode())
                with open(p, "rb") as fh:
                    h.update(fh.read())
    _SRC_HASH = h.hexdigest()[:16]
    return _SRC_HASH


def _jaxlib_version() -> str:
    # jaxlib can diverge from jax; a jaxlib-only upgrade must not
    # deserialize an executable built against a different runtime.
    try:
        import jaxlib.version

        return jaxlib.version.__version__
    except Exception:
        try:
            import jax

            return jax.lib.__version__  # older layouts
        except Exception:
            return "unknown"


def _signature(name: str, statics: dict, args) -> str:
    import jax

    leaves, treedef = jax.tree.flatten(args)
    d = jax.devices()[0]
    parts = [
        name,
        source_hash(),
        jax.__version__,
        _jaxlib_version(),
        getattr(d, "platform", ""),
        getattr(d, "device_kind", ""),
        getattr(d.client, "platform_version", ""),
        str(len(jax.devices())),
        repr(sorted(statics.items())),
        str(treedef),
        ";".join(
            f"{jax.numpy.shape(l)}:{jax.numpy.result_type(l)}:"
            # Differently-sharded inputs compile different executables
            # (host numpy leaves have no sharding and hash as '').
            f"{getattr(l, 'sharding', '')}"
            for l in leaves),
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


def _entry_path(key: str) -> Optional[str]:
    d = _cache_dir()
    return None if d is None else os.path.join(d, key + ".pkl")


# Entries are keyed by package source hash, so every code change strands
# the previous version's executables (~40MB each at production shapes);
# prune anything not touched in this many days when storing new ones.
_PRUNE_AGE_DAYS = 14


def _prune_stale(dirname: str, keep: str) -> None:
    import time

    cutoff = time.time() - _PRUNE_AGE_DAYS * 86400
    # .partial temp files are strandable (a writer killed mid-persist at
    # interpreter exit); anything older than an hour is certainly dead.
    partial_cutoff = time.time() - 3600
    try:
        for fn in os.listdir(dirname):
            p = os.path.join(dirname, fn)
            if p == keep:
                continue
            if fn.endswith(".pkl") and os.path.getmtime(p) < cutoff:
                os.unlink(p)
            elif fn.endswith(".partial") \
                    and os.path.getmtime(p) < partial_cutoff:
                os.unlink(p)
    except OSError:
        pass


def _store(path: str, compiled) -> None:
    import jax
    from jax.experimental import serialize_executable as se

    blob = se.serialize(compiled)
    # Record how many devices the program was compiled for: the loader
    # must hand deserialize_and_load exactly that many execution devices
    # (its default — every client device — breaks single-device programs
    # on multi-device clients, e.g. the forced-8-device CPU test mesh).
    try:
        n_devices = len(
            compiled._executable.xla_executable.local_devices())
    except Exception:
        n_devices = 1
    from linearham_tpu.utils.fileio import atomic_write

    with atomic_write(path, "wb") as fh:
        pickle.dump({"blob": blob, "n_devices": n_devices}, fh)
    _prune_stale(os.path.dirname(path), keep=path)


def _load(path: str):
    import jax
    from jax.experimental import serialize_executable as se

    from linearham_tpu.utils.runtime import platform_policy

    if platform_policy().pruning_kernel:
        # A cached executable may call the pruning kernel's FFI target,
        # which must be registered in this process before it runs.
        from linearham_tpu.ops.pruning_kernel import register

        register()

    with open(path, "rb") as fh:
        entry = pickle.load(fh)
    devs = jax.devices()[:entry["n_devices"]]
    return se.deserialize_and_load(*entry["blob"], execution_devices=devs)


def cached_call(jitfn, name: str, statics: dict, *args):
    """Call ``jitfn(*args, **statics)`` through the executable cache.

    Cache hit: deserialize once per process, then dispatch directly.
    Miss: ordinary jit call (persistent compile cache still applies),
    then the compiled executable is serialized to disk in a background
    thread (lower/compile after a call are in-memory cache hits, so the
    only added cost is pickling, off the critical path).
    """
    global _ATEXIT
    path = _entry_path(_signature(name, statics, args))
    if path is None:
        return jitfn(*args, **statics)
    with _LOCK:
        fn = _MEM.get(path)
    if fn is None and os.path.exists(path):
        try:
            fn = _load(path)
        except Exception:
            try:
                os.unlink(path)
            except OSError:
                pass
            fn = None
        if fn is not None:
            with _LOCK:
                _MEM[path] = fn
    if fn is not None and fn is not _POISONED:
        try:
            return fn(*args)
        except Exception:
            # A loaded executable that fails to RUN is poisoned for this
            # process only; the on-disk entry stays.  Load-time failures
            # (corrupt pickle, deserialize error) already unlinked above;
            # an execution failure here is usually transient (device OOM)
            # and must not evict a valid multi-MB entry that
            # every later process would have to recompile and re-persist.
            # The jit path below still produces the result.
            with _LOCK:
                _MEM[path] = _POISONED

    out = jitfn(*args, **statics)

    def persist():
        try:
            compiled = jitfn.lower(*args, **statics).compile()
            _store(path, compiled)
            with _LOCK:
                _MEM[path] = compiled  # this-process-compiled: known good
        except Exception:
            pass  # cache population is best-effort
        finally:
            with _LOCK:
                _INFLIGHT.pop(path, None)

    if not os.path.exists(path):
        # One persist thread per entry: serialize+write of a ~39MB
        # executable takes seconds, and the pipeline calls the same
        # signature once per chunk — without the in-flight guard every
        # pre-completion call would spawn another identical writer.
        with _LOCK:
            spawn = path not in _INFLIGHT
            if spawn:
                t = threading.Thread(target=persist, daemon=True)
                _INFLIGHT[path] = t
                if not _ATEXIT:
                    # A persist thread killed inside XLA's C++ at
                    # interpreter exit aborts the process: let in-flight
                    # persists finish first.
                    atexit.register(flush, 300.0)
                    _ATEXIT = True
        if spawn:
            t.start()
    return out


def flush(timeout: Optional[float] = 120.0) -> bool:
    """Join in-flight persist threads; True if all completed.

    Persists run on daemon threads so they never block a long-lived
    pipeline process, but a short-lived process (notably the ``warmup``
    CLI subcommand, whose entire purpose is leaving caches populated)
    must call this before exiting, or the ~40MB executable serialization
    can be killed mid-write and the exec cache silently stays cold.
    """
    import time

    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        with _LOCK:
            threads = [t for t in _INFLIGHT.values() if t.is_alive()]
        if not threads:
            return True
        for t in threads:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            t.join(left)
            if deadline is not None and time.monotonic() >= deadline:
                with _LOCK:
                    return not any(
                        t.is_alive() for t in _INFLIGHT.values())
