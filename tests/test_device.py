"""Device checks and run-time setup: compile-cache placement, refusing a
non-GPU backend, and the multi-device dryrun's device-count check."""

import os

import jax
import pytest

from ransac_tpu.utils import device
from tests.conftest import REPO_ROOT


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        # JAX's own setting: this program sets nothing.
        assert device.compile_cache_dir("gpu") is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert device.compile_cache_dir("gpu") == os.path.join(
            REPO_ROOT, ".jax_cache")
    assert device.compile_cache_dir("cpu") is None
    # On this CPU-only run the config is left as it was.
    assert device.enable_compile_cache() == before
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu()


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    assert "{" not in capsys.readouterr().out


def test_dryrun_multichip_raises_with_too_few_devices():
    from __graft_entry__ import dryrun_multichip

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        dryrun_multichip(n)
