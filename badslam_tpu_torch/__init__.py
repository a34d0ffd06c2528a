"""badslam-tpu, PyTorch/CUDA port: direct RGB-D SLAM on one NVIDIA GPU.

The package mirrors the layout of ``badslam_tpu`` (the JAX reference):
``badslam_tpu/ops/depth_proc.py`` <-> ``badslam_tpu_torch/ops/depth_proc.py``,
with the same public function names, argument order and array layouts.
It imports ``torch`` and never ``jax``.

Importing the package pins float32 products. Every Gauss-Newton H/b
reduction is a (6, N) @ (N, 6) product; TF32 keeps ~3 decimal digits, and
reduced-precision products measurably cost odometry and BA accuracy in the
reference (PERF.md "Matmul precision"), so both cuBLAS and cuDNN stay in
full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
