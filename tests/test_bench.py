"""``bench.py``'s failure handling: a failed section is recorded and
turns the exit code non-zero; without a GPU the run does not start."""

import os
import subprocess
import sys

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guarded_records_failure(monkeypatch, capsys):
    monkeypatch.setattr(bench, "FAILED", [])
    monkeypatch.setattr(bench, "RECORD", {"extra": {}})

    def boom():
        raise RuntimeError("section broke")

    assert bench.guarded("ok_section", lambda: 7) == 7
    assert bench.FAILED == []
    assert bench.guarded("bad_section", boom) is None
    assert bench.FAILED == ["bad_section"]
    assert "section broke" in bench.RECORD["extra"]["bad_section_error"]
    assert '"bad_section_error"' in capsys.readouterr().out


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_SMOKE="1")
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 2
    assert "bench needs a GPU" in r.stderr and r.stdout == ""
