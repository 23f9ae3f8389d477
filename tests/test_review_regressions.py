"""Regression tests for the round-1 code-review findings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ransac_tpu.models import ransac as R
from ransac_tpu.models.ransac import _select_best
from ransac_tpu.ops import homography as hops
from ransac_tpu.pipelines.localize import score_candidates
from ransac_tpu.utils.config import LocalizeConfig, RansacConfig


def test_select_best_count_tiebreak_small_msac():
    """counts*1e9 - msac in f32 loses sub-1024 msac tie-breaks; the
    two-step lexicographic selection must not."""
    counts = jnp.asarray([10.0, 10.0, 9.0])
    msac = jnp.asarray([0.5, 1e-4, 1e-6])
    assert int(_select_best(counts, msac, "count")) == 1
    assert int(_select_best(counts, msac, "msac")) == 2


def test_ransac_homography_respects_point_mask():
    """Hypotheses whose minimal sample touches a masked point must be
    invalidated, and masked points never appear as inliers."""
    rng = np.random.default_rng(1)
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(13, 2)).astype(np.float32)
    dst = np.array(hops.apply_h(jnp.asarray(H_true), jnp.asarray(src)),
                   dtype=np.float32)
    # Corrupt masked-out rows grossly: if they leaked into samples AND won,
    # the inlier set would be tiny/garbage.
    dst[9:] = rng.uniform(-5000, 5000, size=(4, 2))
    mask = np.ones(13, np.float32)
    mask[9:] = 0.0
    res = R.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        RansacConfig(threshold=5.0, num_hypotheses=4096, exhaustive=False),
        jax.random.key(2))
    got = np.asarray(res.inlier_mask)
    assert not got[9:].any()
    assert got[:9].sum() >= 8


@pytest.mark.slow
def test_degenerate_candidate_cannot_hijack_argmin():
    """A candidate placed AT a landmark (d_east ~ 0 -> garbage projection,
    potentially singular H / NaN scores) must not beat valid candidates."""
    rng = np.random.default_rng(2)
    cam = np.array([-500.0, 0.0, 50.0])
    X = rng.uniform(-100, 100, size=(13, 3)) + np.array([0, 0, 80.0])
    p = X - cam
    pos2 = np.stack([p[:, 2] / p[:, 0], p[:, 1] / p[:, 0]], 1)
    H_true = np.array([[900.0, 10, 500], [-15, 850, 400], [1e-3, 2e-3, 1]])
    pix = np.asarray(hops.apply_h(jnp.asarray(H_true), jnp.asarray(pos2)))
    cam_locs = np.stack([
        cam,                       # the true camera
        X[0],                      # ON a landmark: d_east = 0 row
        X[4] + [1e-6, 0, 0],       # pathologically close
        cam + [100.0, 40.0, 10.0],
    ]).astype(np.float32)
    out = score_candidates(
        jnp.asarray(pix, jnp.float32), jnp.asarray(X, jnp.float32),
        jnp.ones(13), jnp.asarray(cam_locs), jnp.ones(4, jnp.int32),
        LocalizeConfig(ransac=RansacConfig(threshold=5.0)),
        jax.random.key(0))
    assert int(out["best"]) == 0
    assert np.isfinite(float(out["best_err2"]))


def test_minimal_dlt_centroid_aligned_sample():
    """A sample point sitting exactly at the sample centroid x must not
    make the minimal solve fail: every ordering of a general-position
    4-point sample solves, and maps src onto dst."""
    from itertools import permutations

    # Exactly 4 points, x = [1, 0, 2, 1]: any ordering whose first point
    # has x == mean(x) = 1 zeroes the first pivot of a naive elimination.
    # General position otherwise (no 3 collinear).
    src = np.array([[1.0, 0.0], [0.0, 1.0], [2.0, 1.3], [1.0, 3.0]],
                   np.float32)
    H_true = np.array([[100.0, 3.0, 40.0], [-2.0, 95.0, 30.0],
                       [1e-3, -1e-3, 1.0]])
    dst = np.array(hops.apply_h(jnp.asarray(H_true), jnp.asarray(src)),
                   dtype=np.float32)
    perms = np.array(list(permutations(range(4))))
    Hs, ok = jax.vmap(hops.dlt_homography_minimal)(
        jnp.asarray(src[perms]), jnp.asarray(dst[perms]))
    assert np.asarray(ok).all()
    mapped = np.asarray(jax.vmap(hops.apply_h, (0, None))(
        Hs, jnp.asarray(src)))
    np.testing.assert_allclose(mapped, np.broadcast_to(dst, mapped.shape),
                               atol=1e-2)


def test_fastio_stray_single_field_row(tmp_path):
    """Rows with a blank first cell are skipped identically by the numeric
    and string parsers (desync regression)."""
    from ransac_tpu.io import native

    if not native.available() and not native.build():
        import pytest

        pytest.skip("no native toolchain")
    path = str(tmp_path / "t.csv")
    open(path, "w").write(
        "id,name,v\n1,alpha,10\n\n  \n2,beta,20\n,orphan,99\n3,gamma,30\n")
    nums = native.read_numeric(path, [0, 2])
    names = native.read_strings(path, 1)
    assert nums.shape[0] == len(names) == 3
    assert names == ["alpha", "beta", "gamma"]
    np.testing.assert_allclose(nums[:, 1], [10, 20, 30])
