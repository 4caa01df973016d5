"""Huber regression of the mono-scaled disparity fit, without scikit-learn.

The JAX package fits ``sklearn.linear_model.HuberRegressor(fit_intercept=
False)`` (``voldor_tpu/slam/system.py:904``). This module minimises the same
objective the same way: scikit-learn's ``_huber_loss_and_gradient`` (the
Huber loss with its scale sigma fitted jointly, Owen 2007), written here with
the same array operations, by ``scipy.optimize.minimize(method="L-BFGS-B")``
from (coef, sigma) = (0, 1) with sigma bounded below by 10 x float64 eps,
``maxiter`` 100 and ``gtol`` 1e-5. On the same inputs it returns the
regressor's ``coef_``.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

EPSILON = 1.35  # HuberRegressor defaults
ALPHA = 1e-4
MAX_ITER = 100
TOL = 1e-5


def draw_scale_subsample(rng, n: int, k: int) -> np.ndarray:
    """The fit's pixel subsample: the first k of a permutation of n
    (``np.random.permutation(n)[:k]`` in the JAX package, which draws from
    numpy's global state; here from ``rng``)."""
    return rng.permutation(n)[:k]


def _loss_and_grad(w, X, y, epsilon, alpha, sample_weight):
    """scikit-learn's _huber_loss_and_gradient without an intercept: w is
    (coef..., sigma); returns the loss and its gradient."""
    n_features = X.shape[1]
    sigma = w[-1]
    w = w[:n_features]
    n_samples = np.sum(sample_weight)

    linear_loss = y - X @ w
    abs_linear_loss = np.abs(linear_loss)
    outliers_mask = abs_linear_loss > epsilon * sigma

    # the linear loss of the outliers: (2 M |r| / sigma - M^2) sigma
    outliers = abs_linear_loss[outliers_mask]
    num_outliers = np.count_nonzero(outliers_mask)
    n_non_outliers = X.shape[0] - num_outliers
    outliers_sw = sample_weight[outliers_mask]
    n_sw_outliers = np.sum(outliers_sw)
    outlier_loss = (2.0 * epsilon * np.sum(outliers_sw * outliers)
                    - sigma * n_sw_outliers * epsilon**2)

    # the quadratic loss of the rest: r^2 / sigma
    non_outliers = linear_loss[~outliers_mask]
    weighted_non_outliers = sample_weight[~outliers_mask] * non_outliers
    weighted_loss = np.dot(weighted_non_outliers.T, non_outliers)
    squared_loss = weighted_loss / sigma

    grad = np.zeros(n_features + 1)
    X_non_outliers = -_rows(X, ~outliers_mask, n_non_outliers)
    grad[:n_features] = 2.0 / sigma * (weighted_non_outliers @ X_non_outliers)

    signed_outliers = np.ones_like(outliers)
    signed_outliers[linear_loss[outliers_mask] < 0] = -1.0
    X_outliers = _rows(X, outliers_mask, num_outliers)
    sw_outliers = sample_weight[outliers_mask] * signed_outliers
    grad[:n_features] -= 2.0 * epsilon * (sw_outliers @ X_outliers)
    grad[:n_features] += alpha * 2.0 * w

    grad[-1] = n_samples
    grad[-1] -= n_sw_outliers * epsilon**2
    grad[-1] -= squared_loss / sigma

    loss = n_samples * sigma + squared_loss + outlier_loss
    loss += alpha * np.dot(w, w)
    return loss, grad


def _rows(X, mask, n):
    """X[mask] (scikit-learn's axis0_safe_slice: an empty (0, d) slice when
    no row is selected)."""
    return X[mask, :] if n else np.zeros(shape=(0, X.shape[1]))


def huber_coef(src: np.ndarray, dst: np.ndarray) -> float:
    """The coefficient of dst ~ coef * src under the Huber loss
    (HuberRegressor(fit_intercept=False).fit(src[:, None], dst).coef_[0]).
    Raises RuntimeError when L-BFGS-B reports an abnormal stop (status 2),
    where the regressor raises ValueError."""
    X = np.asarray(src).reshape(-1, 1)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    y = np.asarray(dst)
    if y.dtype not in (np.float32, np.float64):
        y = y.astype(np.float64)
    sample_weight = np.ones(X.shape[0])
    params = np.zeros(2)
    params[-1] = 1.0
    bounds = np.tile([-np.inf, np.inf], (2, 1))
    bounds[-1][0] = np.finfo(np.float64).eps * 10
    res = optimize.minimize(
        _loss_and_grad, params, method="L-BFGS-B", jac=True,
        args=(X, y, EPSILON, ALPHA, sample_weight),
        options={"maxiter": MAX_ITER, "gtol": TOL}, bounds=bounds,
    )
    if res.status == 2:
        raise RuntimeError(f"Huber scale fit failed: L-BFGS-B stopped with {res.message}")
    return float(res.x[0])
