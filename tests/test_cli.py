"""CLI tests: drive sodac's main() in-process (CPU platform via conftest).

Mirrors the reference's CLI surface checks (flag precedence, artifact
emission) — SURVEY.md §2.1 L1."""

import pathlib
import shutil
import subprocess

import pytest

from soda_tpu.cli.sodac import main

SODA = pathlib.Path(__file__).parent / "soda"


def test_report(capsys):
    rc = main([str(SODA / "jacobi3d.soda"), "--grid-shape", "64,64,128",
               "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "compile report: jacobi3d" in out
    assert "8.000 B/cell per sweep" in out
    assert "ops per cell-update: 7.0" in out
    assert "compile wall-clock" in out


def test_report_iterate_ideal(capsys):
    """jacobi2d iterate 8: the fused ideal is 8 B/cell over 8 sweeps."""
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,128",
               "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "sweeps per call: 8" in out
    assert "1.000 B/cell-update with all 8 sweep(s) fused" in out
    assert "border-invalid rim 8" in out


def test_run_verifies(capsys):
    rc = main([str(SODA / "blur.soda"), "--grid-shape", "48,128", "--run"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "blur_y: bit-exact" in out
    assert "verification vs NumPy oracle: PASS" in out


def test_run_xla_backend(capsys):
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "32,64",
               "--run", "--backend", "xla"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS" in out


def test_mesh_run(capsys):
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64",
               "--run", "--mesh", "8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS" in out


def test_mesh_run_named_axes_dcn(capsys):
    """Named mesh axes with a dcn axis + per-axis exchange cadence."""
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64",
               "--run", "--mesh", "dcn:2,x:4",
               "--sweeps-per-exchange", "4,2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS" in out


def test_mesh_run_named_axes_auto_cadence(capsys):
    """dcn axis with no explicit cadence: modeled auto choice from the
    calibrated --link-model; without one the dcn cost is refused."""
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64",
               "--run", "--mesh", "dcn:2,x:4", "--link-model", "dcn=5:1e-4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS" in out
    from soda_tpu.parallel.mesh import LINK_MODEL
    LINK_MODEL.clear()
    with pytest.raises(ValueError, match="link-model"):
        main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64",
              "--run", "--mesh", "dcn:2,x:4"])


def test_cli_override_beats_dsl(capsys):
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64",
               "--iterate", "2", "--report"])
    assert rc == 0
    assert "sweeps per call: 2" in capsys.readouterr().out  # DSL said 8


def test_tcse_flag(capsys):
    """--tcse rewrites seidel2d into fewer ops per cell and still passes
    the oracle."""
    def ops(argv):
        assert main(argv) == 0
        out = capsys.readouterr().out
        return float(out.split("ops per cell-update: ")[1].split()[0]), out

    base = [str(SODA / "seidel2d.soda"), "--grid-shape", "64,128",
            "--report"]
    before, _ = ops(base)
    after, out = ops(base + ["--tcse", "--run"])
    assert after < before
    assert "PASS" in out


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_xocl_compat_artifacts_compile(tmp_path):
    k = tmp_path / "kernel.cpp"
    h = tmp_path / "header.h"
    rc = main([str(SODA / "blur.soda"), "--grid-shape", "24,32",
               "--xocl-kernel", str(k), "--xocl-header", str(h)])
    assert rc == 0
    assert "SODA_VALID_RIM" in h.read_text()
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp_path / "x"),
                    str(k)], check=True, capture_output=True)


def test_rank_mismatch_exits_nonzero():
    with pytest.raises(SystemExit):
        main([str(SODA / "jacobi3d.soda"), "--grid-shape", "64,64",
              "--report"])


def test_grid_shape_from_tile_size(capsys):
    # no --grid-shape: derived from the input tile size ('*' -> 512)
    rc = main([str(SODA / "blur.soda"), "--report"])
    assert rc == 0
    assert "compile report: blur 2000x512" in capsys.readouterr().out


def test_benchmark_names_device(capsys):
    rc = main([str(SODA / "blur.soda"), "--grid-shape", "48,128",
               "--benchmark"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "benchmark (xla on cpu 'cpu', " in out
    assert "xla cost model" in out


def test_mesh_overlap_flag():
    """--mesh-overlap routes through the comms/compute-overlap path (the
    conftest's 8-device CPU sim)."""
    rc = main([
        str(SODA / "jacobi2d.soda"), "--grid-shape", "64,128",
        "--mesh", "4", "--mesh-overlap", "--run"])
    assert rc == 0


def test_host_tile_auto_needs_budget_on_cpu():
    """The CPU reports no memory limit: --host-tile auto without
    --hbm-budget is refused by name."""
    with pytest.raises(SystemExit, match="--hbm-budget"):
        main([str(SODA / "blur.soda"), "--grid-shape", "64,128",
              "--host-tile", "auto", "--run"])


def test_host_tile_run_and_report(capsys):
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "60,180",
               "--host-tile", "40,64", "--run", "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "host tiling: 2x3 tiles of 40x64" in out
    assert "read amplification" in out
    assert "PASS" in out


def test_host_tile_mesh_report(capsys):
    # report-only (no run): the mesh-composed tile line models the
    # exchange traffic and the per-shard shape
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "60,180",
               "--host-tile", "40,64", "--mesh", "2", "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh per tile: shards of" in out
    assert "modeled halo exchange" in out
    assert "/device/pass" in out  # KiB at this tile size, MiB at scale


def test_host_tile_sweeps_auto(capsys):
    # 'auto' cadence resolves to a divisor of iterate and still passes
    # the oracle; joint with auto tiles
    rc = main([str(SODA / "jacobi2d.soda"), "--grid-shape", "48,256",
               "--host-tile", "auto", "--hbm-budget", str(600 * 2**10),
               "--host-tile-sweeps", "auto", "--run",
               "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "host tiling:" in out
    assert "PASS" in out


def test_host_tile_auto(capsys):
    # budget small enough to force tiling of the 64-row dim
    rc = main([str(SODA / "blur.soda"), "--grid-shape", "64,128",
               "--host-tile", "auto", "--hbm-budget", str(40 * 2**10),
               "--run"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASS" in out
