"""``chip_smoke.py``: its CPU-checkable parts here, and the same checks on
the card under the ``gpu`` marker (each compares the GPU with JAX's CPU
backend in one process)."""

import jax
import numpy as np
import pytest

import chip_smoke as cs


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_scene_localizes_through_cli(tmp_path):
    """The scene writer's CSVs through ``cli.main(["localize", ...])``
    at a reduced candidate count: the planted candidate wins and PnP lands
    near the planted camera."""
    scene = cs.write_scene(str(tmp_path), n_candidates=24, seed=1)
    res, _, out = cs.run_localize(scene)
    assert f"best location: index {scene['planted']} " in out
    assert len(res.err2) == 24
    assert cs.check_localization(res, scene) < cs.PNP_ORIGIN_TOL_M
    order = np.argsort(res.err2)
    assert order[0] == scene["planted"]
    assert res.err2[order[1]] > 5 * res.err2[order[0]]


@pytest.mark.gpu
def test_localize_gpu_matches_cpu(gpu, tmp_path):
    scene = cs.write_scene(str(tmp_path))
    res, _, _ = cs.run_localize(scene)
    cs.check_localization(res, scene)
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu, _, _ = cs.run_localize(scene)
    cs.compare_localizations(res, res_cpu)


@pytest.mark.gpu
def test_raycast_gpu_matches_cpu(gpu, tmp_path):
    scene = cs.write_scene(str(tmp_path))
    res, _, _ = cs.run_localize(scene)
    pix = cs.raycast_pixels()
    got = cs.build_inverter(res, scene).pixel_to_geo(pix)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = cs.build_inverter(res, scene).pixel_to_geo(pix)
    cs.compare_raycasts(got, ref)


@pytest.mark.gpu
def test_twoview_gpu_pose(gpu):
    from ransac_tpu.pipelines.sfm_demo import synth_trajectory_frames
    from ransac_tpu.pipelines.twoview import two_view_pipeline
    from ransac_tpu.utils.config import TwoViewConfig

    imgs, K, centers, _ = synth_trajectory_frames(F=2, H=1024, W=1024)
    res = two_view_pipeline(imgs[0], imgs[1], K,
                            TwoViewConfig(max_keypoints=512))
    rot, tdir = cs.twoview_errors(res, centers)
    assert rot <= cs.TWOVIEW_ROT_TOL_DEG
    assert tdir <= cs.TWOVIEW_TDIR_TOL_DEG
