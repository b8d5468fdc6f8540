"""Compute ops of nerve_tpu_torch, NHWC like ``nerve_tpu.ops``.

Nine of them carry hand-written CUDA kernels for Hopper
(``nerve_tpu_torch/csrc``): ``depth_to_space_packed`` and
``depth_to_space_packed_planar``, ``correlation_volume``,
``conv_chain_apply`` (dense and depthwise layers), ``planar_chain_apply``,
``rdb_chain_apply``, ``rdb_taps_apply`` (the RDB under the TPU kernels'
rounding contracts) and the int8 ``conv_chain_int8_apply`` and
``rdb_chain_int8_apply``. Each
runs its kernel on a CUDA tensor and its plain PyTorch version on a CPU
tensor (see ``ops.dispatch``). The rest is plain PyTorch, as it was plain
XLA in the JAX package. Importing builds nothing. Under autograd the ops the
training forward runs (``conv_chain_apply``, ``rdb_chain_apply``,
``correlation_volume``, ``flow_warp``) are ``torch.autograd.Function``s
whose backward is the JAX package's ``custom_vjp`` backward: the vjp of the
plain formulation.
"""

from nerve_tpu_torch.ops.pixel_shuffle import (  # noqa: F401
    depth_to_space_packed,
    depth_to_space_packed_planar,
    pixel_shuffle,
    pixel_shuffle_planar,
)
from nerve_tpu_torch.ops.resize import (  # noqa: F401
    resize_bicubic,
    resize_bilinear,
    upsample_bicubic_channels,
    upsample_bilinear_channels,
)
from nerve_tpu_torch.ops.conv_chain import conv_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.planar_chain import planar_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.rdb import rdb_chain_apply  # noqa: F401
from nerve_tpu_torch.ops.rdb_taps import rdb_taps_apply  # noqa: F401
from nerve_tpu_torch.ops.conv_chain_int8 import conv_chain_int8_apply  # noqa: F401
from nerve_tpu_torch.ops.rdb_int8 import rdb_chain_int8_apply  # noqa: F401
from nerve_tpu_torch.ops.warp import flow_warp  # noqa: F401
from nerve_tpu_torch.ops.correlation import correlation_volume  # noqa: F401
from nerve_tpu_torch.ops.pool import (  # noqa: F401
    adaptive_avg_pool2d,
    avg_pool2d,
    global_avg_pool,
    max_pool2d,
    max_pool3d_spatial,
)
