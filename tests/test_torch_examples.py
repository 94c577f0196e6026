"""The four examples on the PyTorch port (``examples/torch_*.py``) beside
the JAX package's (``examples/*.py``), on the CPU: each pair runs as
subprocesses, all eight side by side, and their deterministic lines
agree.

- quickstart: every line, floats within a relative 5e-2 (Eq. 3 fp
  across math libraries), every other token identical;
- serve_sessions: the generated tokens' shape, both migration lines
  (lineage status, fp, ACCEPT / REFUSE);
- async_pods: every round's verdicts and the ``[recovery]`` line;
- train_100m at ``--small``: the restore line (step, lineage,
  admitted) and the final clock sum.

Losses, evaluation losses and generated tokens differ: the port draws
its weights from a seeded ``torch.Generator``, not from JAX's PRNG.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"quickstart": [], "serve_sessions": [], "async_pods": [],
            "train_100m": ["--small"]}
FP_RTOL = 5e-2
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


def _run(script: str, args: list) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, os.path.join("examples", script)]
                            + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def outputs():
    """{name: (port lines, reference lines)}, every run side by side."""
    procs = {name: (_run(f"torch_{name}.py", args + ["--device", "cpu"]),
                    _run(f"{name}.py", args))
             for name, args in EXAMPLES.items()}
    out = {}
    for name, pair in procs.items():
        lines = []
        for p in pair:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, (name, stderr[-4000:])
            lines.append(stdout.splitlines())
        out[name] = tuple(lines)
    return out


def same_line(a: str, b: str) -> bool:
    """Equal but for floats within ``FP_RTOL`` (integers exact)."""
    if NUM.sub("#", a) != NUM.sub("#", b):
        return False
    for x, y in zip(NUM.findall(a), NUM.findall(b)):
        if "." in x or "e" in x:
            fx, fy = float(x), float(y)
            if abs(fx - fy) > FP_RTOL * max(abs(fx), abs(fy)):
                return False
        elif x != y:
            return False
    return True


def _pick(lines: list, prefix: str) -> list:
    return [s for s in lines if s.startswith(prefix)]


def test_quickstart_every_line(outputs):
    port, ref = outputs["quickstart"]
    assert len(port) == len(ref) == 13, port
    for a, b in zip(port, ref):
        assert same_line(a, b), (a, b)


def test_serve_sessions_verdicts(outputs):
    port, ref = outputs["serve_sessions"]
    shape = [re.search(r"generated: (\([^)]*\))", s).group(1)
             for s in (port[0], ref[0])]
    assert shape[0] == shape[1] == "(4, 12)"
    migrate = [_pick(x, "[serve] migrate") for x in (port, ref)]
    assert len(migrate[0]) == 2 and "ACCEPT" in migrate[0][0] \
        and "REFUSE" in migrate[0][1]
    for a, b in zip(*migrate):
        assert same_line(a, b), (a, b)


def test_async_pods_verdicts(outputs):
    port, ref = outputs["async_pods"]
    verdicts = [[s[s.index("{"):] for s in _pick(x, "[round ")]
                for x in (port, ref)]
    assert len(verdicts[0]) == 8 and verdicts[0] == verdicts[1]
    assert "REJECTED(forked)" in verdicts[0][4]
    assert _pick(port, "[recovery]") == _pick(ref, "[recovery]") == [
        "[recovery] pod3 readmitted: True"]


def test_train_100m_small_restore_and_clock(outputs):
    port, ref = outputs["train_100m"]
    restore = [_pick(x, "[example] restore") for x in (port, ref)]
    assert restore[0] == restore[1] == [
        "[example] restore step=10 lineage=descendant admitted=True"]
    clock = [re.search(r"clock sum (\d+)", x[-1]).group(1)
             for x in (port, ref)]
    assert clock[0] == clock[1], clock
