"""Fused kernels and compiled pipelines (the slot the reference's embedded
OpenCL C kernels occupy — physicl/light.py:146-158,239-249,303-315 and the
CLProgram assembler at physicl/__init__.py:567-664)."""

from physicl_tpu.ops import fused  # noqa: F401
