"""chip_smoke.py: refuses any platform but the GPU, and its phases rehearse
on the CPU at tiny sizes through the `tiny`/`platform` hook (the command
line always runs full sizes on the GPU)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_refuses_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "need 'gpu'" in r.stderr


def test_rehearsal_last_line(capsys):
    """All one-card phases at tiny sizes; the last stdout line is the
    result object, with the device as JAX reports it."""
    assert chip_smoke.main([], tiny=True, platform="cpu") == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    assert res == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                          "count": 8}}
    for phase in ("--- corpus", "--- at size", "--- host tiling",
                  "--- timing"):
        assert phase in out
    corpus = len(list(chip_smoke.SODA.glob("*.soda")))
    runs = corpus + len(chip_smoke.TINY["at_size"]) + 1
    assert out.count("verification vs NumPy oracle: PASS") == runs
    assert "FAIL" not in out


def test_four_cards_rehearsal(capsys):
    """--four-cards on the virtual CPU devices: the mesh runs are
    oracle-checked and bit-exact against the one-device run."""
    assert chip_smoke.main(["--four-cards"], tiny=True, platform="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("vs one card, t1: bit-exact") == 2
    assert "--- corpus" not in out
    assert _last_json(out)["ok"] is True


@pytest.mark.gpu
def test_compiled_corpus_on_gpu(gpu_device, capsys):
    """The corpus through the compiled path on the card."""
    failures = []
    chip_smoke.phase_corpus(failures)
    assert not failures
