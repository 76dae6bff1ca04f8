"""Single-buffer device placement for many-leaf pytrees.

Every device_put LEAF pays a fixed per-array cost on top of bandwidth
(how much on a local GPU is not measured yet; ROADMAP D2), so a stacked
repertoire bucket of ~30 leaves pays it ~30 times.
``device_put_packed`` concatenates the leaves into ONE flat host buffer
per dtype, ships those few buffers with a single device_put, and slices
them back into the original arrays on device with one jitted
static-slicing program (pure reshape/slice — compiles in well under a
second and hits the persistent cache thereafter).

Exactness: leaves are raveled and concatenated byte-for-byte per dtype;
the unpack is static slicing + reshape, so every array round-trips
bit-identically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("spec",))
def _unpack(buffers, spec):
    """Slice each dtype buffer back into its leaves (static offsets)."""
    out = {}
    for key, items in spec:
        buf = buffers[key]
        off = 0
        for idx, shape in items:
            n = 1
            for s in shape:
                n *= s
            out[idx] = buf[off:off + n].reshape(shape)
            off += n
    # Leaf indices may have gaps (device-resident leaves bypass packing);
    # return in ascending-index order, matching the caller's sorted map.
    return tuple(out[i] for i in sorted(out))


def device_put_packed(tree):
    """jax.device_put(tree), but with one wire buffer per leaf dtype.

    Returns the same pytree structure with device arrays.  Scalars and
    zero-size leaves are handled; dtypes are preserved exactly.
    """
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves:
        return tree
    groups = {}
    passthrough = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, jax.Array):
            # Already on device: np.asarray would force a device->host
            # read just to re-upload it.
            # Leave it in place, exactly as jax.device_put would.
            passthrough[i] = leaf
            continue
        a = np.asarray(leaf)
        groups.setdefault(a.dtype.str, []).append((i, a))
    buffers = {}
    spec = []
    for key in sorted(groups):
        items = groups[key]
        buffers[key] = np.concatenate([a.ravel() for _, a in items])
        spec.append((key, tuple((i, a.shape) for i, a in items)))
    if groups:
        dev = jax.device_put(buffers)
        unpacked = _unpack(dev, spec=tuple(spec))
        order = [i for _, items in spec for i, _ in items]
        # _unpack returns leaves sorted by original index
        packed_out = dict(zip(sorted(order), unpacked))
    else:
        packed_out = {}
    out = [passthrough[i] if i in passthrough else packed_out[i]
           for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, out)
