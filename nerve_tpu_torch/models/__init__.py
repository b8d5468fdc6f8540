"""Models of nerve_tpu_torch (the serving models of ``nerve_tpu.models``)."""

from nerve_tpu_torch.models.bridge import (  # noqa: F401
    abr_from_flax,
    adaptive_engine_from_flax,
    engine_from_flax,
    flax_variables,
    lightweight_from_flax,
    load_flax_variables,
    recovery_from_flax,
    sr_from_flax,
)
from nerve_tpu_torch.models.enhancement_engine import (  # noqa: F401
    AdaptiveEnhancementEngine,
    EnhancementEngine,
    EngineConfig,
    select_mode_for_budget,
)
from nerve_tpu_torch.models.frame_recovery import FrameRecoveryNet  # noqa: F401
from nerve_tpu_torch.models.quantize import (  # noqa: F401
    calibrate_sr_scales,
    quantize_engine,
    quantize_sr,
    rdb_params_from_tree,
)
from nerve_tpu_torch.models.streaming import (  # noqa: F401
    enhance_video_streaming,
    streaming_prime,
    streaming_step,
    streaming_step_pair,
)
from nerve_tpu_torch.models.super_resolution import (  # noqa: F401
    LightweightSuperResolution,
    SuperResolutionNet,
    estimate_sr_flops,
)
