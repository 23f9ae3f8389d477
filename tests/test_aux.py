"""Aux subsystems: CLI, checkpointing, profiling, config round-trips."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from ransac_tpu.utils import config as cfgmod
from ransac_tpu.utils.checkpointing import CheckpointManager
from ransac_tpu.utils.logging import Metrics, timed
from ransac_tpu.utils.profiling import KernelReport, SolProfiler
from tests.conftest import REFERENCE_DIR, REPO_ROOT, reference_available


def test_config_from_mapping_nested():
    cfg = cfgmod.from_mapping(cfgmod.LocalizeConfig, {
        "grid_code_min": 7,
        "ransac": {"threshold": 120.0, "selection": "count"},
    })
    assert cfg.grid_code_min == 7
    assert cfg.ransac.threshold == 120.0
    assert cfg.ransac.selection == "count"
    # Untouched defaults intact.
    assert cfg.pnp_ransac.threshold == 30.0
    d = cfgmod.asdict(cfg)
    assert d["ransac"]["threshold"] == 120.0


def test_metrics_registry():
    m = Metrics()
    m.record("x", 1.0, tag="a")
    m.record("x", 2.0)
    assert m.latest("x") == 2.0
    assert len(m.all("x")) == 2
    with timed("block", registry=m):
        pass
    assert m.latest("block") >= 0


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = {"cams": np.arange(12.0).reshape(2, 6),
             "pts": np.ones((5, 3), np.float32)}
    mgr.save(0, state)
    state2 = {"cams": state["cams"] + 1, "pts": state["pts"] * 2}
    mgr.save(1, state2)
    assert mgr.latest_step() == 1
    got = mgr.restore(template=state)
    np.testing.assert_allclose(got["cams"], state2["cams"])
    np.testing.assert_allclose(got["pts"], state2["pts"])
    mgr.close()


def test_sol_profiler_reports():
    import jax

    prof = SolProfiler(peaks=dict(hbm_bytes=1e11, fp32_flops=1e11,
                                  tf32_flops=1e12))
    f = jax.jit(lambda x: x * 2.0 + 1.0)
    x = jnp.ones((1000,))
    _, rep = prof.measure("axpy", f, x, flops=2000, bytes_moved=8000, iters=3)
    assert rep.seconds > 0
    assert 0 <= rep.sol
    assert rep.sol == max(rep.sol_compute, rep.sol_memory)
    assert "axpy" in prof.table()


def test_device_peaks_unknown_kind_raises():
    from ransac_tpu.utils.profiling import PEAKS, device_peaks

    for kind, peaks in PEAKS.items():
        assert device_peaks(kind) is peaks
        assert set(peaks) == {"hbm_bytes", "fp32_flops", "tf32_flops"}
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
    with pytest.raises(KeyError):
        SolProfiler()  # the CPU backend has no published peaks


@pytest.mark.skipif(not reference_available(), reason="reference data absent")
@pytest.mark.slow
def test_cli_localize_end_to_end(tmp_path):
    out = tmp_path / "zOut.jpg"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "ransac_tpu.cli", "localize",
         "--features", os.path.join(REFERENCE_DIR,
                                    "feature_points_with_annotations.csv"),
         "--cameras", os.path.join(REFERENCE_DIR,
                                   "potential_camera_locations.csv"),
         "--pixel-x", "Pixel_x_1898.jpg", "--pixel-y", "Pixel_y_1898.jpg",
         "--width", "2142", "--height", "1620",
         "--output", str(out)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "best location" in r.stdout
    csv_path = tmp_path / "zOut_location.csv"
    assert csv_path.exists()
    assert sum(1 for _ in open(csv_path)) == 459


def test_cli_help():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "ransac_tpu.cli", "--help"],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0
    for sub in ("localize", "twoview", "intrinsics", "bench"):
        assert sub in r.stdout
