"""PyTorch / CUDA port of the keypoint-sequence inpainter for one NVIDIA H100.

It sits beside ``keypoints_interpolation_transformer_tpu`` (the JAX
reference, which it never imports at run time) and mirrors its layout:

  ops/          attention-bias builders, the composite, and ``ops/kernels``:
                hand-written CUDA kernels (``csrc/*.cu``) with their plain
                PyTorch versions beside them
  transforms/   ``add_sos`` and ``zero_missing_frames``
  models/       ``KeypointCompleter`` (plain and Cycle flags) under the
                reference ``.pth`` state-dict names, and the converters
  eval/         ``Inpainter``, ``RequestBatcher`` and the HTTP server
  cli.py        the ``serve`` subcommand

CPU tensors take the plain versions; CUDA tensors take the kernels.
"""

import torch

# The plain versions double as the kernels' oracles on the card: keep every
# float32 product in full float32 there.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
