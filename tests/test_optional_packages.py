"""The package and its netCDF-3 path run without h5py and matplotlib, which
a deployment need not have; netCDF-4 without h5py fails with a clear error
that names the netCDF-3 route."""

import subprocess
import sys

import numpy as np
import pytest

from xcontour_tpu.utils import ncio


def test_import_pulls_in_neither_h5py_nor_matplotlib():
    code = ("import sys, xcontour_tpu, xcontour_tpu.cli; "
            "print(sorted(m for m in ('h5py', 'matplotlib') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"JAX_PLATFORMS": "cpu",
                                         "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_nc3_round_trip_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)    # import h5py fails
    path = str(tmp_path / "a.nc")
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    ncio.save_dataset_nc3(path, {"v": v}, {"v": ("y", "x")})
    for lazy in (False, True):
        ds = ncio.load_dataset(path, lazy=lazy)
        np.testing.assert_array_equal(np.asarray(ds["v"]), v)
        assert ds.dims_of("v") == ("y", "x")


def test_nc4_without_h5py_names_the_nc3_route(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(tmp_path / "b.nc")
    with pytest.raises(ImportError, match="--format nc3"):
        ncio.save_dataset(path, {"v": np.zeros(3)}, {"v": ("x",)})
    with open(path, "wb") as f:                       # an HDF5 signature
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(ImportError, match="--format nc3"):
        ncio.load_dataset(path)
