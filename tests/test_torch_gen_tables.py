"""PyTorch port, the CDF-table generator (vcm_ts_tpu_torch
.gen_gaussian_tables): regenerating gives the shipped port file's arrays
exactly, and a path inside the JAX package is refused. Also the import
rule of the port's tool CLIs: they import with JAX, the JAX package,
tools/, cv2 and PIL blocked.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from vcm_ts_tpu_torch import gen_gaussian_tables as gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_regenerated_tables_equal_the_shipped_file(tmp_path):
    out = gen.main(["--out", str(tmp_path / "gaussian_cdf.npz")])
    with np.load(out) as got, np.load(gen.OUT) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rel", ["vcm_ts_tpu/entropy/data/gaussian_cdf.npz",
                                 "vcm_ts_tpu/x.npz"])
def test_a_path_in_the_jax_package_is_refused(rel):
    path = os.path.join(REPO, rel)
    before = os.path.getmtime(path) if os.path.exists(path) else None
    with pytest.raises(ValueError, match="JAX package"):
        gen.main(["--out", path])
    after = os.path.getmtime(path) if os.path.exists(path) else None
    assert before == after


SLICE = ("vcm_ts_tpu_torch.overfit_run",
         "vcm_ts_tpu_torch.bf16_bd_gate",
         "vcm_ts_tpu_torch.protocol_run",
         "vcm_ts_tpu_torch.ocr_domain_gate",
         "vcm_ts_tpu_torch.gen_gaussian_tables")


def test_slice_imports_without_jax_cv2_or_pil():
    """The five tool CLIs import with jax, flax, the JAX package, tools/,
    cv2 and PIL blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'vcm_ts_tpu', 'tools', 'cv2', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {SLICE!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
