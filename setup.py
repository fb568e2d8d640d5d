"""Packaging for deepspeed_tpu (reference setup.py, minus the CUDA op
build machinery — TPU kernels are Pallas, compiled by XLA at trace time)
and its PyTorch/CUDA port deepspeed_tpu_torch, whose kernel sources ship
as package data and build with nvcc at first use."""

from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version=open("deepspeed_tpu/version.py").read().split('"')[1],
    description="TPU-native DeepSpeed-equivalent training/inference framework (JAX/XLA/Pallas)",
    packages=find_packages(
        include=["deepspeed_tpu", "deepspeed_tpu.*", "deepspeed_tpu_torch", "deepspeed_tpu_torch.*"]
    ),
    package_data={"deepspeed_tpu_torch.ops.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "optax", "orbax-checkpoint", "numpy", "einops"],
    entry_points={
        "console_scripts": [
            "dstpu=deepspeed_tpu.launcher.runner:main",
            "dstpu_report=deepspeed_tpu.env_report:main",
            "dstpu_io=deepspeed_tpu.utils.io_bench:main",
            "dstpu_bench=deepspeed_tpu.utils.comm_bench:main",
            "dstpu_elastic=deepspeed_tpu.elasticity.cli:main",
            "dstpu_ssh=deepspeed_tpu.launcher.ssh_tool:main",
        ]
    },
)
