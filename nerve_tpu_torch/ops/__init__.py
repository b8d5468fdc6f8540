"""Compute ops of nerve_tpu_torch, NHWC like ``nerve_tpu.ops``.

Seven of them carry hand-written CUDA kernels for Hopper
(``nerve_tpu_torch/csrc``): ``depth_to_space_packed``,
``correlation_volume``, ``conv_chain_apply`` (dense and depthwise layers),
``planar_chain_apply``, ``rdb_chain_apply`` and the int8
``conv_chain_int8_apply`` and ``rdb_chain_int8_apply``. Each
runs its kernel on a CUDA tensor and its plain PyTorch version on a CPU
tensor (see ``ops.dispatch``). The rest is plain PyTorch, as it was plain
XLA in the JAX package. Importing builds nothing.
"""

from nerve_tpu_torch.ops.pixel_shuffle import (  # noqa: F401
    depth_to_space_packed,
    pixel_shuffle,
    pixel_shuffle_planar,
)
from nerve_tpu_torch.ops.resize import (  # noqa: F401
    resize_bilinear,
    upsample_bicubic_channels,
    upsample_bilinear_channels,
)
from nerve_tpu_torch.ops.conv_chain import conv_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.planar_chain import planar_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.rdb import rdb_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.conv_chain_int8 import conv_chain_int8_apply  # noqa: F401
from nerve_tpu_torch.ops.rdb_int8 import rdb_chain_int8_apply  # noqa: F401
from nerve_tpu_torch.ops.warp import flow_warp  # noqa: F401
from nerve_tpu_torch.ops.correlation import correlation_volume  # noqa: F401
from nerve_tpu_torch.ops.pool import avg_pool2d, global_avg_pool  # noqa: F401
