"""Device table, device-derived defaults, compile-cache placement and the
mesh's link costs."""

import os
import subprocess
import sys
import types

import jax
import pytest

from soda_tpu.utils import compile_cache, device
from soda_tpu.utils.device import DEVICES, device_spec, hbm_budget


def test_h100_row_from_datasheet():
    s = device_spec("NVIDIA H100 80GB HBM3")
    assert s.hbm_bytes_per_s == 3.35e12
    assert s.hbm_bytes == 80 * 10**9
    assert s.link_bytes_per_s == 450e9
    assert s.f32_flops_per_s == 67e12
    assert "data sheet" in s.source


def test_every_row_names_its_source():
    assert DEVICES["cpu"].source.startswith("nominal")
    for s in DEVICES.values():
        assert s.source and s.kind


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="not in the device table"):
        device_spec("Imaginary Accelerator 9000")


def test_default_kind_is_first_device():
    assert device_spec() is DEVICES[jax.devices()[0].device_kind]


def _fake_device(stats):
    return types.SimpleNamespace(memory_stats=lambda: stats)


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 64 * 2**30}, int(64 * 2**30 * (1 - device.HBM_SLACK))),
    ({"bytes_in_use": 5}, None),
    (None, None),
])
def test_hbm_budget_from_memory_stats(stats, want):
    assert hbm_budget(_fake_device(stats)) == want


def test_cpu_reports_no_budget():
    assert hbm_budget(jax.devices()[0]) is None


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(tmp_path):
    """Without the variable the cache is <repo>/.jax_cache (checked in a
    child process, so this process's JAX config is left alone)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != compile_cache.ENV}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo
    code = ("import jax; from soda_tpu.utils.compile_cache import "
            "enable_compile_cache, REPO_CACHE; d = enable_compile_cache(); "
            "assert d == str(REPO_CACHE) == "
            "jax.config.jax_compilation_cache_dir; print(d)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == os.path.join(repo, ".jax_cache")


def test_link_costs():
    from soda_tpu.parallel.mesh import LINK_MODEL, link_cost, set_link_model

    h100 = device_spec("NVIDIA H100 80GB HBM3")
    saved = dict(LINK_MODEL)
    try:
        LINK_MODEL.clear()
        assert link_cost("nvlink", h100) == (450.0, h100.link_latency_s)
        with pytest.raises(ValueError, match="--link-model"):
            link_cost("dcn", h100)
        set_link_model("dcn=25:1e-4,nvlink=400:8e-6")
        assert link_cost("dcn", h100) == (25.0, 1e-4)
        assert link_cost("nvlink", h100) == (400.0, 8e-6)
    finally:
        LINK_MODEL.clear()
        LINK_MODEL.update(saved)
