"""Packaging (ref counterpart: setup.py + requirements.txt — C28)."""

import re

from setuptools import find_packages, setup

with open("sgtapose_tpu/__init__.py") as f:
    version = re.search(r'__version__ = "([^"]+)"', f.read()).group(1)

setup(
    name="sgtapose_tpu",
    version=version,
    description=(
        "TPU-native framework for camera-to-robot pose estimation from image "
        "sequences (structure-prior guided temporal attention), built on "
        "JAX/Flax/Pallas"
    ),
    # sgtapose_tpu_torch: the PyTorch/CUDA port (imports torch, not jax);
    # its CUDA kernels are built from csrc/*.cu by nvcc at first use on a GPU
    packages=find_packages(include=["sgtapose_tpu", "sgtapose_tpu.*",
                                    "sgtapose_tpu_torch", "sgtapose_tpu_torch.*"]),
    package_data={"sgtapose_tpu.native": ["*.cpp"], "sgtapose_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pillow",
        "scipy",
    ],
    entry_points={
        "console_scripts": [
            "sgtapose-train=sgtapose_tpu.cli.train:main",
            "sgtapose-infer=sgtapose_tpu.cli.infer:main",
        ]
    },
)
