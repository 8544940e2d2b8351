"""The examples' torch twins (``examples/*_torch.py``) run end to end on the
CPU at a tiny size, each in a fresh interpreter that must not load JAX or
the JAX package: the image pipeline through ``ops.dequant_u8``, then
``train_lm_torch.py`` (a checkpoint, and a resume from it) and
``serve_lm_torch.py`` serving that checkpoint."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs an example as __main__, then reports any JAX or JAX-package module loaded
_RUNNER = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    "print('JAX-MODULES:', ','.join(sorted(bad)))\n"
)


def _run(tmp_path, example, *args):
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, os.path.join(REPO, "examples", example), *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-MODULES: \n" in out.stdout, out.stdout
    return out.stdout


def test_image_pipeline_twin_runs_on_the_cpu(tmp_path):
    # 300 images: one full batch of 256 and one partial batch
    out = _run(tmp_path, "image_pipeline_torch.py", "--device", "cpu", "--n", "300")
    assert "images: 300  batch: 256  device: cpu" in out
    assert "ra pipeline" in out and "png pipeline" in out and "speedup" in out


def test_train_and_serve_twins_run_on_the_cpu(tmp_path):
    work = str(tmp_path / "work")
    out = _run(tmp_path, "train_lm_torch.py", "--device", "cpu", "--steps", "3", "--batch", "2",
               "--workdir", work)
    assert "[data] 2048 docs x 256 tokens" in out and "[done] steps=3" in out
    assert os.path.isdir(os.path.join(work, "ckpt", "step_00000003"))
    out = _run(tmp_path, "train_lm_torch.py", "--device", "cpu", "--steps", "5", "--batch", "2",
               "--workdir", work)
    assert "resumed from step 3" in out and "[done] steps=5" in out
    out = _run(tmp_path, "serve_lm_torch.py", "--device", "cpu", "--batch", "2", "--max-new",
               "3", "--workdir", work)
    assert "step_00000005" in out and "generated (2, 3) tokens" in out
    out = _run(tmp_path, "serve_lm_torch.py", "--device", "cpu", "--batch", "2", "--max-new",
               "3", "--random")
    assert "random init" in out
