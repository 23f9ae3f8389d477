"""The RANSAC engine's hypothesis scorer (``models.ransac.score_hypotheses``,
the scoring stage of ``ransac_fit``) against a float64 NumPy loop."""

from functools import partial

import jax.numpy as jnp
import numpy as np

from ransac_tpu.models import ransac as R


def _score_np(residual_np, models, x, y, mask, thr):
    """Per-hypothesis float64 reference: (counts, msac, borderline) where
    ``borderline`` marks hypotheses with a residual within 1e-4 of the
    threshold (float32 may legitimately classify those either way)."""
    counts, msac, border = [], [], []
    m = mask.astype(bool)
    for model in models:
        r = residual_np(np.asarray(model, np.float64), x, y)
        r_sq = np.where(np.isfinite(r), r * r, np.inf)
        counts.append(int(((r_sq <= thr * thr) & m).sum()))
        msac.append(float(np.where(m, np.minimum(r_sq, thr * thr), 0).sum()))
        border.append(bool((np.abs(r[m] - thr) < 1e-4).any()))
    return np.array(counts), np.array(msac), np.array(border)


def _h_residual_np(H, x, y):
    xh = np.concatenate([x, np.ones((len(x), 1))], 1) @ H.T
    w = np.where(np.abs(xh[:, 2]) < 1e-12, 1e-12, xh[:, 2])
    return np.linalg.norm(xh[:, :2] / w[:, None] - y, axis=1)


def _pnp_residual_np(model, X, pix_n):
    Rm, t = model[:9].reshape(3, 3), model[9:12]
    Xc = X @ Rm.T + t
    z = Xc[:, 2]
    good = z > 1e-6
    uv = Xc[:, :2] / np.where(good, z, 1.0)[:, None]
    return np.where(good, np.linalg.norm(uv - pix_n, axis=1), np.inf)


def _check(got, ref):
    counts, msac = (np.asarray(a) for a in got[1:])
    c_ref, m_ref, border = ref
    np.testing.assert_array_equal(counts[~border], c_ref[~border])
    assert np.all(np.abs(counts[border] - c_ref[border]) <= 1)
    np.testing.assert_allclose(msac, m_ref, rtol=1e-4, atol=1e-5)


def test_homography_kernel_matches_reference():
    rng = np.random.default_rng(0)
    H = 4096 + 77
    models = np.eye(3)[None] + rng.normal(scale=0.1, size=(H, 3, 3))
    src = rng.uniform(-2, 2, size=(13, 2)).astype(np.float32)
    dst = rng.uniform(-2, 2, size=(13, 2)).astype(np.float32)
    mask = np.ones(13)
    mask[11:] = 0
    got = R.score_hypotheses(
        jnp.asarray(models, jnp.float32), jnp.ones(H, bool), R._h_residual,
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), 1.5)
    ref = _score_np(_h_residual_np, models.astype(np.float32), src, dst,
                    mask, 1.5)
    _check(got, ref)


def test_pnp_kernel_matches_reference():
    rng = np.random.default_rng(1)
    H = 2048
    from ransac_tpu.ops.rotation import exp_so3

    Rm = np.asarray(exp_so3(jnp.asarray(rng.normal(size=(H, 3)) * 0.5)))
    t = rng.normal(size=(H, 3)) * np.array([1, 1, 5]) + [0, 0, 6]
    models = np.concatenate([Rm.reshape(H, 9), t], axis=1).astype(np.float32)
    Xw = rng.uniform(-2, 2, size=(12, 3)).astype(np.float32)
    pix_n = rng.uniform(-0.5, 0.5, size=(12, 2)).astype(np.float32)
    mask = np.ones(12)
    mask[10:] = 0
    got = R.score_hypotheses(
        jnp.asarray(models), jnp.ones(H, bool),
        partial(R._pnp_residual, ay=1.0), jnp.asarray(Xw),
        jnp.asarray(pix_n), jnp.asarray(mask), 0.02)
    ref = _score_np(_pnp_residual_np, models, Xw, pix_n, mask, 0.02)
    _check(got, ref)


def test_pnp_kernel_cheirality():
    # Points behind every camera -> zero inliers, msac = N * thr^2.
    models = np.concatenate(
        [np.tile(np.eye(3).reshape(9), (64, 1)),
         np.tile(np.array([0.0, 0, -100.0]), (64, 1))], axis=1)
    Xw = np.tile(np.array([[0.0, 0, 5.0]]), (8, 1))
    pix = np.zeros((8, 2))
    mask = np.ones(8)
    inlier, c, m = R.score_hypotheses(
        jnp.asarray(models, jnp.float32), jnp.ones(64, bool),
        partial(R._pnp_residual, ay=1.0), jnp.asarray(Xw, jnp.float32),
        jnp.asarray(pix, jnp.float32), jnp.asarray(mask), 0.1)
    assert not np.asarray(inlier).any()
    assert np.all(np.asarray(c) == 0)
    np.testing.assert_allclose(np.asarray(m), 8 * 0.1**2, rtol=1e-5)
    c_ref, m_ref, _ = _score_np(_pnp_residual_np, models, Xw, pix, mask, 0.1)
    np.testing.assert_array_equal(c_ref, 0)
    np.testing.assert_allclose(m_ref, 8 * 0.1**2)
