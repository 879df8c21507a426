"""``examples/quickstart_torch.py`` (the port's quickstart) runs end to end
on the CPU at a cut epoch count, as ``tests/test_docs.py::
test_quickstart_example_runs`` runs the JAX package's, in a process where
``jax`` and the JAX package cannot be imported."""

import os
import subprocess
import sys

from conftest import REPO_ROOT

# every import of these names fails in the example's process
_BLOCK = ("import runpy, sys\n"
          "for name in ('jax', 'jaxlib', 'optax', 'defensive_model_vae_tpu'):\n"
          "    sys.modules[name] = None\n"
          "sys.argv = sys.argv[1:]\n"
          "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def test_quickstart_torch_runs_without_jax(tmp_path):
    script = REPO_ROOT / "examples" / "quickstart_torch.py"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK, str(script), "--epochs", "200", "--device", "cpu",
         "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env={**os.environ, "MPLBACKEND": "Agg", "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "tracked" in proc.stdout and "figures in" in proc.stdout
    for fig in ("loss.png", "generated_vs_training.png", "tracking.png"):
        assert (tmp_path / fig).stat().st_size > 0
    assert (tmp_path / "ckpt").is_dir()
