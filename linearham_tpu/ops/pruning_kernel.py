"""The GPU pruning kernel (native/pruning.cu) as a JAX operation.

Drop-in replacement for ``ops.pruning.site_log_likelihoods`` batched over
trees, driven by slot-reuse schedules (io/schedule.py).  Why a kernel: the
jnp path carries one ``[R, 4, X]`` partial per internal node for every tree
of a chunk through a ``lax.scan``, so each post-order step moves the child,
parent and updated parent slices of the whole chunk through device memory
(and the carry alone outgrows the card at production chunk sizes).  The
kernel keeps a tree's ~log2(tips) live partials in shared memory; its only
device-memory traffic is the schedule, the shared xMSA codes and the
``[T, X]`` output.

The library is built from native/pruning.cu at first use (``make`` in
native/, output under native/build/, which git ignores): with nvcc for the
GPU, or with the host C++ compiler for the CPU, where the same per-thread
arithmetic runs serially so the CPU tests exercise the kernel's own code.
The platform policy (utils/runtime.py) sends production f32 runs on the
GPU here; on the CPU only tests call it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

TARGET = "lh_prune"
MAX_RATES = 16          # blockDim = 64 sites x R rates <= 1024 threads

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIBS = {"gpu": "build/liblh_prune_cuda.so",
         "cpu": "build/liblh_prune_host.so"}
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}
_REGISTERED: set = set()
_LOCK = threading.Lock()


def build(platform: str) -> str:
    """Build the kernel library for ``platform`` ('gpu' or 'cpu') unless it
    is current; returns its path.  Equivalent to
    ``make -C native build/liblh_prune_cuda.so`` (or ``..._host.so``)."""
    target = _LIBS[platform]
    proc = subprocess.run(
        ["make", "-s", target, f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
        cwd=_NATIVE_DIR, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {target} failed:\n{proc.stdout}{proc.stderr}")
    return os.path.join(_NATIVE_DIR, target)


def register(platform: str = None) -> None:
    """Build and register the FFI target for ``platform`` (default: the
    platform of ``jax.devices()[0]``), once per process."""
    platform = platform or jax.devices()[0].platform
    with _LOCK:
        if platform in _REGISTERED:
            return
        lib = ctypes.cdll.LoadLibrary(build(platform))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.LhPrune),
            platform=_FFI_PLATFORM[platform])
        _REGISTERED.add(platform)


def site_log_likelihoods_kernel(
    eig,                       # GTREigen, u/u_inv [..., T, 4, 4], lam [..., T, 4]
    pi: jnp.ndarray,           # [..., T, 4]
    rates: jnp.ndarray,        # [..., T, R]
    row_codes: jnp.ndarray,    # [..., n_rows, X] xMSA codes (shared by trees)
    sched_src: jnp.ndarray,    # [..., T, N] xMSA row (tips) / child slot
    sched_penc: jnp.ndarray,   # [..., T, N] parent*4 + first*2 + is_tip; -1 pad
    sched_len: jnp.ndarray,    # [..., T, N] branch lengths
    sched_root: jnp.ndarray,   # [..., T] live slot of the root partial
    n_slots: int,
) -> jnp.ndarray:
    """Per-site rate-mixed log-likelihoods [..., T, X] in float32.

    Leading dimensions are batch dimensions shared by every argument (a
    vmap over families lands here as one launch over all their trees).
    """
    R = rates.shape[-1]
    if not 1 <= R <= MAX_RATES:
        raise ValueError(f"the pruning kernel takes 1..{MAX_RATES} rate "
                         f"categories, got {R}")
    register()
    f32, i32 = jnp.float32, jnp.int32
    out_shape = sched_src.shape[:-1] + row_codes.shape[-1:]
    call = jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct(out_shape, f32),
        vmap_method="broadcast_all")
    return call(
        row_codes.astype(i32), sched_src.astype(i32),
        sched_penc.astype(i32), sched_len.astype(f32),
        sched_root.astype(i32), eig.u.astype(f32), eig.u_inv.astype(f32),
        eig.lam.astype(f32), pi.astype(f32), rates.astype(f32),
        n_slots=np.int32(n_slots))
