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


def test_new_modules_pull_in_neither_jax_nor_triton(tmp_path):
    """The public surface of the later slices (utilities, the command
    line, the streamed sweep, profiling, the frame mesh and the
    multi-process sweep) imports no JAX, Triton or JAX package module
    and builds neither kernels nor native modules."""
    code = (
        "import sys\n"
        "import pywindow_torch.utilities, pywindow_torch.__main__\n"
        "from pywindow_torch.parallel import batch, distributed, mesh\n"
        "from pywindow_torch import native, profiling, trajectory\n"
        "from pywindow_torch.ops import cluster, encoding, geometry\n"
        "bad = [m for m in ('jax', 'triton', 'pywindow_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "from pywindow_torch.ops import _cuda\n"
        "assert _cuda.load_extension.cache_info().currsize == 0\n"
        "assert native.lib.cache_info().currsize == 0\n"
        "assert native.fastprops.cache_info().currsize == 0\n"
        "assert not profiling.enabled()\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYWINDOW_TORCH_PROFILE"}
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=tmp_path,
        env={**env, "PYTHONPATH": str(root)},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
