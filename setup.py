"""Packaging for ctunet_tpu (parity surface: reference ``setup.py:17-32``,
console script ``ctunet`` -> ``ctunet-tpu``)."""

from setuptools import find_packages, setup

setup(
    name="ctunet_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) 3D U-Net framework for CT skull-shape "
        "completion — the capability surface of vfmatzkin/ct-unet, "
        "re-designed TPU-first"
    ),
    packages=find_packages(include=["ctunet_tpu", "ctunet_tpu.*",
                                    "ctunet_tpu_torch", "ctunet_tpu_torch.*"]),
    # the PyTorch port builds its CUDA kernels from csrc/ at first use and
    # ships the trained UNetSP weights
    package_data={"ctunet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                       "assets/*.npz"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "flax", "optax", "orbax-checkpoint"],
    extras_require={
        "host": ["pandas", "scipy"],
        "torch-port": ["torch"],
        "tensorboard": ["torch", "tensorboard"],
    },
    entry_points={
        "console_scripts": [
            "ctunet-tpu=ctunet_tpu.trainer:cli",
            "ctunet-tpu-torch=ctunet_tpu_torch.trainer:cli",
        ],
    },
)
