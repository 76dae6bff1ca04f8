"""GTR substitution model and discrete-gamma rate machinery.

The GTR rate matrix Q is built from 6 exchangeabilities (RevBayes order
AC, AG, AT, CG, CT, GT) and a stationary distribution pi, normalized to one
expected substitution per unit branch length.  Transition matrices come
from the similarity-symmetrized eigendecomposition, which is stable and
batches cleanly (jnp.linalg.eigh over a [..., 4, 4] stack) -- the
accelerator-native replacement for libpll's eigen machinery (reference
boundary: src/PhyloHMM.cpp:350-370).

Gamma categories use the mean-per-category discretization (the reference's
PLL_GAMMA_RATES_MEAN, src/PhyloHMM.cpp:360,425): category boundaries are
Gamma(alpha, alpha) quantiles and each category rate is the distribution
mean within its bin, computed host-side with scipy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import gamma as _gamma_dist


def gamma_category_rates(alpha: float, n_rates: int) -> np.ndarray:
    """Mean-per-category discrete gamma rates (host, float64). [n_rates]"""
    if n_rates == 1:
        return np.ones(1)
    # X ~ Gamma(shape=alpha, rate=alpha), mean 1.
    edges = _gamma_dist.ppf(
        np.arange(1, n_rates) / n_rates, alpha, scale=1.0 / alpha)
    edges = np.concatenate([[0.0], edges, [np.inf]])
    # E[X; a<X<b] = F_{alpha+1}(b) - F_{alpha+1}(a) for mean-1 gamma.
    cdf_up = _gamma_dist.cdf(edges, alpha + 1.0, scale=1.0 / alpha)
    return n_rates * np.diff(cdf_up)


def gamma_category_rates_batch(alphas, n_rates: int) -> np.ndarray:
    """gamma_category_rates vectorized over a [T] batch of shapes.

    One vectorized ppf/cdf call instead of T scalar ones: the per-sample
    loop costs ~150 ms per 1024 posterior rows of host prep.
    """
    alphas = np.asarray(alphas, np.float64)
    T = alphas.shape[0]
    if n_rates == 1:
        return np.ones((T, 1))
    a = alphas[:, None]
    edges = _gamma_dist.ppf(
        (np.arange(1, n_rates) / n_rates)[None, :], a, scale=1.0 / a)
    edges = np.concatenate(
        [np.zeros((T, 1)), edges, np.full((T, 1), np.inf)], axis=1)
    cdf_up = _gamma_dist.cdf(edges, a + 1.0, scale=1.0 / a)
    return n_rates * np.diff(cdf_up, axis=1)


class GTREigen(NamedTuple):
    """Eigendecomposition of Q: P(t) = U @ diag(exp(lam * t)) @ Uinv."""

    u: jnp.ndarray      # [..., 4, 4]
    u_inv: jnp.ndarray  # [..., 4, 4]
    lam: jnp.ndarray    # [..., 4]


def gtr_eigen(er, pi) -> GTREigen:
    """Eigendecompose normalized GTR; batches over leading axes.

    er: [..., 6] exchangeabilities (AC, AG, AT, CG, CT, GT); pi: [..., 4].

    Runs on the HOST in numpy: the inputs are per-tree scalars straight
    from the posterior-sample TSV, the matrices are 4x4, and XLA's
    batched eigh both compiles extremely slowly and is unnecessary at
    this size.  The resulting factors are fed to the device kernels.
    """
    er = np.asarray(er, np.float64)
    pi = np.asarray(pi, np.float64)
    batch = er.shape[:-1]
    R = np.zeros(batch + (4, 4))
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for k, (i, j) in enumerate(pairs):
        R[..., i, j] = er[..., k]
        R[..., j, i] = er[..., k]

    Q = R * pi[..., None, :]
    Q = Q - np.eye(4) * Q.sum(axis=-1, keepdims=True)
    # Normalize to mean rate 1: -sum_i pi_i Q_ii = 1.
    mean_rate = -np.sum(
        pi * np.diagonal(Q, axis1=-2, axis2=-1), axis=-1,
        keepdims=True)[..., None]
    Q = Q / mean_rate

    sqrt_pi = np.sqrt(pi)
    sym = Q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    lam, v = np.linalg.eigh(sym)
    u = v / sqrt_pi[..., :, None]
    u_inv = np.swapaxes(v, -1, -2) * sqrt_pi[..., None, :]
    # Host (numpy) outputs on purpose: callers push them to the device in
    # one bulk transfer with the rest of the batch.
    return GTREigen(u=u, u_inv=u_inv, lam=lam)


def transition_matrices(eig: GTREigen, t: jnp.ndarray) -> jnp.ndarray:
    """P(t) for a stack of times; t broadcasts against eig's batch shape.

    Returns [..., t_shape..., 4, 4] row-stochastic matrices.
    """
    expd = jnp.exp(eig.lam[..., None, :] * t[..., :, None])  # [..., T, 4]
    return jnp.einsum(
        "...ij,...tj,...jk->...tik", eig.u, expd, eig.u_inv,
        precision=jax.lax.Precision.HIGHEST,
    )
