"""Matrix-free PCG Schur BA (ba.schur_cg) vs the dense Schur path.

VERDICT r1 item 4: the dense [C,P,6,3] cross tensors cannot scale; the
slot-layout CG path must reproduce the dense results on problems both
can solve, converge on synthetic SfM scenes, and run at shapes the dense
path cannot allocate (scale smoke kept CPU-sized here; the full
512-cam/200k-pt/2M-obs run is ``python -m ransac_tpu.ba.bench``
on the GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ransac_tpu.ba import bundle
from ransac_tpu.ba.schur_cg import (BASlotProblem, bundle_adjust_cg,
                                    from_ba_problem, slot_cost)
from ransac_tpu.utils.config import BundleAdjustConfig


def synth_problem(n_cam=6, n_pt=60, noise=0.01, seed=0, drop=0.3):
    from ransac_tpu.ops import projection as proj
    from ransac_tpu.ops.rotation import exp_so3

    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]])
    pts = rng.uniform(-2, 2, size=(n_pt, 3)) * np.array([3, 3, 1]) + [0, 0, 8]
    cams, obs_cam, obs_pt, obs_uv = [], [], [], []
    for c in range(n_cam):
        cam6 = np.concatenate([rng.normal(size=3) * 0.05,
                               [c * 2.0 / n_cam - 1.0, 0.0, 0.0]])
        cams.append(cam6)
        R = np.asarray(exp_so3(jnp.asarray(cam6[:3])))
        pix, z = proj.project_points(
            jnp.asarray(pts), jnp.asarray(R), jnp.asarray(cam6[3:]),
            jnp.asarray(K))
        keep = np.where(np.asarray(z) > 0)[0]
        keep = keep[rng.random(len(keep)) > drop]
        for i in keep:
            obs_cam.append(c)
            obs_pt.append(i)
            obs_uv.append(np.asarray(pix)[i])
    cams = np.array(cams)
    cams[1:] += rng.normal(scale=0.004, size=cams[1:].shape)
    return bundle.BAProblem(
        cameras=jnp.asarray(cams, jnp.float32),
        points=jnp.asarray(
            pts + rng.normal(scale=noise, size=pts.shape), jnp.float32),
        K=jnp.asarray(K, jnp.float32),
        obs_cam=jnp.asarray(np.array(obs_cam, np.int32)),
        obs_pt=jnp.asarray(np.array(obs_pt, np.int32)),
        obs_uv=jnp.asarray(np.array(obs_uv), jnp.float32),
        obs_w=jnp.ones(len(obs_cam), jnp.float32))


def test_slot_layout_roundtrip_cost():
    p = synth_problem()
    sp = from_ba_problem(p)
    c_list = float(bundle.cost_fn(p, p.cameras, p.points))
    c_slot = float(slot_cost(sp, p.cameras, p.points))
    np.testing.assert_allclose(c_slot, c_list, rtol=1e-6)


def test_cg_matches_dense_schur():
    p = synth_problem()
    cfg = BundleAdjustConfig(max_iters=15)
    dense = bundle.bundle_adjust(p, cfg)
    sp = from_ba_problem(p)
    cg = bundle_adjust_cg(sp, cfg, cg_iters=40)
    # Both converge essentially to the optimum of the same objective.
    assert float(cg.cost) < 0.05 * float(cg.initial_cost)
    np.testing.assert_allclose(float(cg.cost), float(dense.cost),
                               rtol=0.05, atol=1e-4)
    # Non-gauge cameras agree.
    np.testing.assert_allclose(np.asarray(cg.cameras),
                               np.asarray(dense.cameras),
                               rtol=0.05, atol=5e-3)


def test_cg_converges_with_huber_and_outliers():
    p = synth_problem(seed=3)
    uv = np.array(p.obs_uv)
    uv[::15] += 80.0  # gross outlier observations
    p = p._replace(obs_uv=jnp.asarray(uv))
    sp = from_ba_problem(p)
    cfg = BundleAdjustConfig(max_iters=15, huber_scale=4.0)
    res = bundle_adjust_cg(sp, cfg, cg_iters=40)
    assert float(res.cost) < float(res.initial_cost)


def test_cg_scale_smoke_medium():
    """A shape the dense path could NOT allocate as cpij at f32
    ([C,P,6,3] = 64*4000*18*4B is fine, but [C,6,C,6]+cpij pair at the
    real target explodes) — medium CPU-sized here, asserts one accepted
    LM step reduces cost."""
    p = synth_problem(n_cam=24, n_pt=800, seed=5, drop=0.75)
    sp = from_ba_problem(p, max_slots=8)
    cfg = BundleAdjustConfig(max_iters=3)
    res = bundle_adjust_cg(sp, cfg, cg_iters=16)
    assert float(res.cost) < float(res.initial_cost)
    assert np.isfinite(float(res.cost))


def test_distributed_cg_matches_single_device():
    """Point-sharded CG BA over the 8-device mesh == 1-device result
    (camera-side psum is the only cross-shard traffic)."""
    from ransac_tpu.parallel.dist_ba import distributed_bundle_adjust_cg
    from ransac_tpu.parallel.mesh import make_mesh

    p = synth_problem(n_cam=8, n_pt=64, seed=7)
    sp = from_ba_problem(p)
    mesh8 = make_mesh(8, data=8, model=1)
    mesh1 = make_mesh(1, data=1, model=1)
    cams8, pts8, cost8 = distributed_bundle_adjust_cg(
        sp, mesh8, n_iters=6, cg_iters=24)
    cams1, pts1, cost1 = distributed_bundle_adjust_cg(
        sp, mesh1, n_iters=6, cg_iters=24)
    np.testing.assert_allclose(float(cost8), float(cost1),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cams8), np.asarray(cams1),
                               rtol=1e-2, atol=1e-3)
    assert float(cost8) < 0.2 * float(
        slot_cost(sp, sp.cameras, sp.points))
