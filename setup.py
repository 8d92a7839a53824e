from setuptools import setup, find_packages
import io
import re

with io.open("xcontour_tpu/__init__.py", "rt", encoding="utf8") as f:
    version = re.search(r'__version__ = "(.*?)"', f.read()).group(1)

setup(
    name="xcontour_tpu",
    version=version,
    description="Contour-coordinate diagnostics in JAX (XLA, Pallas on the GPU)",
    long_description=open("README.md", encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    keywords="contour jax gpu pallas equivalent-latitude effective-diffusivity",
    packages=find_packages(exclude=["docs", "tests", "examples", "tools"]),
    package_data={"xcontour_tpu": ["../csrc/*.cpp"]},
    entry_points={
        "console_scripts": ["xcontour-tpu = xcontour_tpu.cli:main"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "jax",
    ],
    extras_require={
        "io": ["h5py", "scipy"],
    },
)
