"""Models of nerve_tpu_torch (the SR serving slice of ``nerve_tpu.models``)."""

from nerve_tpu_torch.models.bridge import load_flax_variables, sr_from_flax  # noqa: F401
from nerve_tpu_torch.models.quantize import (  # noqa: F401
    calibrate_sr_scales,
    quantize_sr,
    rdb_params_from_tree,
)
from nerve_tpu_torch.models.streaming import (  # noqa: F401
    enhance_video_streaming,
    streaming_prime,
    streaming_step,
)
from nerve_tpu_torch.models.super_resolution import SuperResolutionNet  # noqa: F401
