"""The four examples on the port (``examples/*_torch.py``) against the
reference's (``examples/*.py``), each run as a script in a subprocess on
the CPU (``--device cpu``): the NoI walkthrough prints the reference's
output line for line (numpy only), the quickstart its Plane B lines, the
serving example's greedy stream matches teacher forcing, and the training
example resumes from its own checkpoint.  Without ``--device cpu`` on a
machine with no card, each refuses to run."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _run(args, *, cwd, timeout=600, check=True):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                       env=env, cwd=str(cwd), timeout=timeout)
    if check:
        assert r.returncode == 0, (args, r.stdout[-2000:], r.stderr[-4000:])
    return r


def test_noi_design_prints_the_references_lines(tmp_path):
    want = _run([EXAMPLES / "noi_design.py"], cwd=tmp_path).stdout
    got = _run([EXAMPLES / "noi_design_torch.py"], cwd=tmp_path).stdout
    assert got.splitlines() == want.splitlines()
    assert "min-EDP design" in got


def test_quickstart_plane_b_lines_equal_the_references(tmp_path):
    """The reference's section 1 (its Plane B, run from its own source up
    to section 2) and the port's whole quickstart on the CPU."""
    src = (EXAMPLES / "quickstart.py").read_text()
    plane_b = src[:src.index("# ── 2.")]
    want = _run(["-c", plane_b], cwd=tmp_path).stdout.splitlines()
    got = _run([EXAMPLES / "quickstart_torch.py", "--device", "cpu"],
               cwd=tmp_path).stdout.splitlines()
    assert len(want) == 4 and got[:4] == want
    assert any(line.startswith("[plane A] one train step: loss=") for line in got)
    err = [line for line in got if line.startswith("[kernels] flash attention")]
    assert len(err) == 1 and float(err[0].split()[-1]) < 1e-5, got


def test_serve_e2e_matches_teacher_forcing(tmp_path):
    out = _run([EXAMPLES / "serve_e2e_torch.py", "--device", "cpu"], cwd=tmp_path).stdout
    assert "drained 12 requests" in out
    assert out.rstrip().endswith("incremental-vs-teacher-forced greedy decode: MATCH"), out


def test_train_lm_resumes_from_its_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    base = [EXAMPLES / "train_lm_torch.py", "--tiny", "--device", "cpu",
            "--ckpt-dir", ckpt]
    first = _run([*base, "--steps", "3"], cwd=tmp_path).stdout
    assert "resumed" not in first and "done: loss" in first
    second = _run([*base, "--steps", "4"], cwd=tmp_path).stdout
    assert "resumed from checkpoint at step 3" in second and "done: loss" in second


@pytest.mark.parametrize("name", ["quickstart", "serve_e2e", "train_lm"])
def test_examples_without_a_card_refuse_to_run_on_the_cpu(tmp_path, name):
    """No ``--device`` and no card: the example raises as the port's entry
    points do (a card is the default)."""
    r = _run(["-c", f"import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
                    f"sys.argv = [{str(EXAMPLES / f'{name}_torch.py')!r}]; "
                    f"runpy.run_path(sys.argv[0], run_name='__main__')"],
             cwd=tmp_path, check=False)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, (r.stdout, r.stderr[-2000:])
