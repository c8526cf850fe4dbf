"""``import pywindow_torch`` loads torch and numpy only: no JAX, no
Triton, no kernel or native-library build."""

import os
import pathlib
import subprocess
import sys


def test_import_pulls_in_neither_jax_nor_triton(tmp_path):
    code = (
        "import sys, pywindow_torch\n"
        "from pywindow_torch.ops import analysis, ray_kernels, cluster_kernels\n"
        "from pywindow_torch.ops import clearance_kernels, rebuild\n"
        "from pywindow_torch import native, trajectory\n"
        "bad = [m for m in ('jax', 'triton', 'pywindow_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "from pywindow_torch.ops import _cuda\n"
        "assert _cuda.load_extension.cache_info().currsize == 0\n"
        "assert native.lib.cache_info().currsize == 0\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(root)},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
