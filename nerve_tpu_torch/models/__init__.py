"""Models of nerve_tpu_torch (the SR serving slice of ``nerve_tpu.models``)."""

from nerve_tpu_torch.models.bridge import (  # noqa: F401
    lightweight_from_flax,
    load_flax_variables,
    sr_from_flax,
)
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
from nerve_tpu_torch.models.super_resolution import (  # noqa: F401
    LightweightSuperResolution,
    SuperResolutionNet,
)
