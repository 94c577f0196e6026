"""The port's multi-process gossip smoke (``repro_torch.launch.peers``)
on the CPU: a leader and two child processes, each serving its clock
over TCP, converge with zero false negatives, and no process imports
JAX.

The test puts a stand-in ``jax`` package that raises on import first on
``PYTHONPATH``, so any import of JAX, or of the JAX package's modules
(which import it), by the leader or a child fails the run.  Bounded by
``subprocess.run(timeout=120)``.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_peers_smoke_three_processes_without_jax(tmp_path):
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('this process must not import jax')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(fake.parent), SRC])}
    trace = tmp_path / "trace"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.peers", "--smoke", "3",
         "--device", "cpu", "--trace-dir", str(trace)],
        env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "[leader] OK: 3 processes converged in 3 rounds" in out
    assert "0 false negatives" in out
    assert out.count("[peer node") == 2
    assert "[leader] trace OK" in out
    assert "must not import jax" not in out
    for name in ("trace.jsonl", "trace.chrome.json", "audit.jsonl"):
        assert (trace / name).exists(), name


def test_peers_cli_refuses_bad_arguments():
    env = {**os.environ, "PYTHONPATH": SRC}
    for args in (["--smoke", "3", "--rounds", "1"], []):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.peers", *args],
            env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2, proc.stderr
