"""Import nerve_cl (PyTorch reference) checkpoints into the port's models.

The port's own copy of ``nerve_tpu/models/import_torch.py``: a ``nerve_cl``
state dict (its ``SuperResolutionNet``, ``LightweightSuperResolution``,
``FrameRecoveryNet``, ``EnhancementEngine`` and
``AdaptiveEnhancementEngine``) becomes the ``{"params", "batch_stats"}``
tree of the JAX package's flax variables, numpy leaves, which
``models.bridge.load_flax_variables`` loads into the port's modules name for
name, strictly, so reference-trained weights serve through the port's
kernels.

Layout conventions handled here:
  * torch Conv2d  (O, I, kH, kW)      → flax HWIO (kH, kW, I, O)
  * torch depthwise Conv2d (C, 1, kH, kW) → (kH, kW, 1, C)
  * torch Conv3d  (O, I, kT, kH, kW)  → (kT, kH, kW, I, O)
  * torch Linear  (O, I)              → (I, O)
  * torch ConvTranspose2d (I, O, kH, kW) → flax ConvTranspose kernel
    (kH, kW, I, O) with the spatial taps FLIPPED: torch's transposed conv is
    the gradient of a correlation (flipped-kernel scatter), while flax's
    ``ConvTranspose`` convolves the dilated input with the kernel as given.
  * torch BatchNorm{2,3}d weight/bias/running_mean/running_var →
    scale/bias (params) + mean/var (batch_stats, the port's BatchNorm
    buffers); num_batches_tracked dropped.
  * The RDB local-feature-fusion 1×1 conv is stored as a 2-D (C_in, F)
    matmul matrix (``ops.rdb``), not a rank-4 kernel.
  * The reference FusionModule's fixed all-ones channel-mean "projections"
    have no state_dict entries; the port's learned projections are set to
    those exact constants so imported forwards reproduce the reference's.
  * The adaptive engine's first Linear takes the 8×8-pooled frame
    channel-first in the reference and NHWC here: its input columns are
    permuted.

Every import function is strict: it consumes the whole state_dict and fills
the whole tree, raising on unknown or missing keys, and the bridge's load
holds the tree against the module's parameters and buffers by name and
shape, so silent drift between the two architectures is impossible.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nerve_tpu_torch.models.enhancement_engine import EngineConfig

Array = np.ndarray
Tree = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Loading
# --------------------------------------------------------------------------- #
def load_state_dict(path: str) -> Dict[str, Array]:
    """Load a torch checkpoint file into a flat dict of numpy arrays.

    Accepts either a bare state_dict or the reference's training checkpoint
    dicts (``{"model_state_dict": ..., ...}``, also ``"state_dict"`` or
    ``"model"``).
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(hasattr(v, "numpy") for v in obj.values()):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj:
                obj = obj[key]
                break
    return state_dict_to_numpy(obj)


def state_dict_to_numpy(sd: Mapping[str, Any]) -> Dict[str, Array]:
    """torch tensors (or arrays) → float32/int numpy, dropping BN counters."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


# --------------------------------------------------------------------------- #
# Layout transforms
# --------------------------------------------------------------------------- #
def _conv(w: Array) -> Array:
    """torch Conv2d (O, I, kH, kW) → HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w: Array) -> Array:
    """torch Conv3d (O, I, kT, kH, kW) → (kT, kH, kW, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _deconv(w: Array) -> Array:
    """torch ConvTranspose2d (I, O, kH, kW) → flax (kH, kW, I, O), flipped."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _linear(w: Array) -> Array:
    return np.ascontiguousarray(w.T)


class _Importer:
    """Consumes a flat torch state_dict into nested params/batch_stats trees."""

    def __init__(self, sd: Mapping[str, Array]):
        self.sd = dict(sd)
        self.params: Tree = {}
        self.stats: Tree = {}

    def take(self, key: str) -> Array:
        if key not in self.sd:
            raise KeyError(f"state_dict missing expected key {key!r}")
        return self.sd.pop(key)

    def _set(self, tree: Tree, path: str, value: Array) -> None:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] in node:
            raise ValueError(f"duplicate import target {path!r}")
        node[parts[-1]] = np.asarray(value, np.float32)

    def put(self, path: str, value: Array) -> None:
        self._set(self.params, path, value)

    def put_stat(self, path: str, value: Array) -> None:
        self._set(self.stats, path, value)

    # -- composite layers --------------------------------------------------- #
    def conv(self, tk: str, fp: str, bias: bool = True) -> None:
        """torch Conv2d at key prefix ``tk`` → ConvParams/nn.Conv at ``fp``."""
        self.put(f"{fp}/kernel", _conv(self.take(f"{tk}.weight")))
        if bias:
            self.put(f"{fp}/bias", self.take(f"{tk}.bias"))

    def bn(self, tk: str, fp: str) -> None:
        self.put(f"{fp}/scale", self.take(f"{tk}.weight"))
        self.put(f"{fp}/bias", self.take(f"{tk}.bias"))
        self.put_stat(f"{fp}/mean", self.take(f"{tk}.running_mean"))
        self.put_stat(f"{fp}/var", self.take(f"{tk}.running_var"))

    def dwsep(self, tk: str, fp: str) -> None:
        """Reference DepthwiseSeparableConv (efficient_layers.py:9-67)."""
        self.put(f"{fp}/depthwise/kernel", _conv(self.take(f"{tk}.depthwise.weight")))
        self.put(f"{fp}/pointwise/kernel", _conv(self.take(f"{tk}.pointwise.weight")))
        self.bn(f"{tk}.bn", f"{fp}/BatchNorm_0")

    def residual_block(self, tk: str, fp: str) -> None:
        """Reference ResidualBlock use_efficient=True (efficient_layers.py:109-151)."""
        self.dwsep(f"{tk}.conv1", f"{fp}/conv1")
        self.put(f"{fp}/conv2_dw/kernel", _conv(self.take(f"{tk}.conv2.0.weight")))
        self.put(f"{fp}/conv2_pw/kernel", _conv(self.take(f"{tk}.conv2.1.weight")))
        self.bn(f"{tk}.conv2.2", f"{fp}/bn2")

    def cbam(self, tk: str, fp: str) -> None:
        """Reference CBAM (efficient_layers.py:208-228)."""
        self.put(
            f"{fp}/ChannelAttention_0/Dense_0/kernel",
            _linear(self.take(f"{tk}.channel_attention.fc.0.weight")),
        )
        self.put(
            f"{fp}/ChannelAttention_0/Dense_1/kernel",
            _linear(self.take(f"{tk}.channel_attention.fc.2.weight")),
        )
        self.put(
            f"{fp}/SpatialAttention_0/conv_kernel",
            _conv(self.take(f"{tk}.spatial_attention.conv.weight")),
        )

    def temporal_conv3d(self, tk: str, fp: str) -> None:
        """Reference TemporalConv3D (efficient_layers.py:231-294)."""
        self.put(f"{fp}/spatial/kernel", _conv3d(self.take(f"{tk}.spatial.0.weight")))
        self.bn(f"{tk}.spatial.1", f"{fp}/spatial_bn")
        self.put(f"{fp}/temporal/kernel", _conv3d(self.take(f"{tk}.temporal.0.weight")))
        self.bn(f"{tk}.temporal.1", f"{fp}/temporal_bn")

    # -- finalise ----------------------------------------------------------- #
    def finish(self) -> Dict[str, Tree]:
        if self.sd:
            raise ValueError(
                f"unconsumed state_dict keys (architecture mismatch?): "
                f"{sorted(self.sd)[:8]}{'...' if len(self.sd) > 8 else ''}"
            )
        out: Dict[str, Tree] = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


# --------------------------------------------------------------------------- #
# Model importers
# --------------------------------------------------------------------------- #
def _import_sr_into(imp: _Importer, p: str, f: str, num_residual_blocks: int) -> None:
    """SuperResolutionNet subtree (reference super_resolution.py:256-431).

    ``p``/``f`` are the torch / flax prefixes ('' for a bare model).
    """
    tp = (p + ".") if p else ""
    fp = (f + "/") if f else ""
    imp.conv(f"{tp}feature_extractor.head.0", f"{fp}feature_extractor/head")
    for i in range(3):
        imp.dwsep(f"{tp}feature_extractor.body.{i}", f"{fp}feature_extractor/body{i}")
    for i, j in enumerate((0, 2, 4, 6)):
        imp.conv(f"{tp}motion_estimator.flow_net.{j}", f"{fp}motion_estimator/flow{i}")
    for i, j in enumerate((0, 2, 4)):
        imp.conv(f"{tp}temporal_aggregator.attention.{j}", f"{fp}temporal_aggregator/attn{i}")
    imp.cbam(f"{tp}temporal_aggregator.refine", f"{fp}temporal_aggregator/refine")
    for b in range(num_residual_blocks):
        for i in range(5):
            imp.put(
                f"{fp}rdbs/rdb{b}_dense{i}_kernel",
                _conv(imp.take(f"{tp}residual_blocks.{b}.layers.{i}.0.weight")),
            )
            imp.put(
                f"{fp}rdbs/rdb{b}_dense{i}_bias",
                imp.take(f"{tp}residual_blocks.{b}.layers.{i}.0.bias"),
            )
        lff = imp.take(f"{tp}residual_blocks.{b}.lff.weight")  # (F, C_in, 1, 1)
        imp.put(f"{fp}rdbs/rdb{b}_lff_kernel", _linear(lff[:, :, 0, 0]))
        imp.put(f"{fp}rdbs/rdb{b}_lff_bias", imp.take(f"{tp}residual_blocks.{b}.lff.bias"))
    imp.conv(f"{tp}gff.0", f"{fp}gff")
    imp.conv(f"{tp}upsampler.conv", f"{fp}upsampler/conv")


def import_super_resolution(
    sd: Mapping[str, Array], num_residual_blocks: int = 8
) -> Dict[str, Tree]:
    """SuperResolutionNet state_dict → flax-shaped variables."""
    imp = _Importer(state_dict_to_numpy(sd))
    _import_sr_into(imp, "", "", num_residual_blocks)
    return imp.finish()


def _import_lightweight_into(imp: _Importer, p: str, f: str) -> None:
    """LightweightSuperResolution (reference super_resolution.py:434-470)."""
    tp = (p + ".") if p else ""
    fp = (f + "/") if f else ""
    imp.conv(f"{tp}net.0", f"{fp}head")
    for i in range(4):
        imp.dwsep(f"{tp}net.{i + 2}", f"{fp}body{i}")
    imp.conv(f"{tp}net.6", f"{fp}tail")


def import_lightweight(sd: Mapping[str, Array]) -> Dict[str, Tree]:
    imp = _Importer(state_dict_to_numpy(sd))
    _import_lightweight_into(imp, "", "")
    return imp.finish()


def _import_recovery_into(
    imp: _Importer, p: str, f: str, base_channels: int = 64
) -> None:
    """FrameRecoveryNet subtree (reference frame_recovery.py:335-446)."""
    tp = (p + ".") if p else ""
    fp = (f + "/") if f else ""

    # Spatial encoder (frame_recovery.py:23-108). torch stage indices: stage1
    # has no downsample (stride 1, ch unchanged) so blocks are .0/.1; stages
    # 2/3 put the 1×1-downsample Sequential at .0 and blocks at .1/.2.
    se_t, se_f = f"{tp}spatial_encoder", f"{fp}spatial_encoder"
    imp.conv(f"{se_t}.stem.0", f"{se_f}/stem", bias=False)
    imp.bn(f"{se_t}.stem.1", f"{se_f}/stem_bn")
    for i in range(2):
        imp.residual_block(f"{se_t}.stage1.{i}", f"{se_f}/stage1_block{i}")
    for s in (2, 3):
        imp.conv(f"{se_t}.stage{s}.0.0", f"{se_f}/stage{s}_down", bias=False)
        imp.bn(f"{se_t}.stage{s}.0.1", f"{se_f}/stage{s}_down_bn")
        for i in range(2):
            imp.residual_block(f"{se_t}.stage{s}.{i + 1}", f"{se_f}/stage{s}_block{i}")
    imp.cbam(f"{se_t}.attention", f"{se_f}/attention")

    # Temporal encoder (frame_recovery.py:111-167).
    for i in (1, 2, 3):
        imp.temporal_conv3d(f"{tp}temporal_encoder.conv{i}", f"{fp}temporal_encoder/conv{i}")

    # Fusion (frame_recovery.py:170-257). The reference's fixed channel-mean
    # projections have no weights — materialise them as constants so the
    # imported model reproduces the reference forward exactly.
    fu_t, fu_f = f"{tp}fusion", f"{fp}fusion"
    imp.conv(f"{fu_t}.align", f"{fu_f}/align")
    imp.conv(f"{fu_t}.attention.0", f"{fu_f}/attn0")
    imp.conv(f"{fu_t}.attention.2", f"{fu_f}/attn1")
    c = base_channels * 4
    imp.put(f"{fu_f}/spatial_proj/kernel", np.full((1, 1, c, c), 1.0 / c, np.float32))
    imp.put(f"{fu_f}/temporal_proj/kernel", np.full((1, 1, c, c), 1.0 / c, np.float32))
    imp.residual_block(f"{fu_t}.refine.0", f"{fu_f}/refine0")
    imp.residual_block(f"{fu_t}.refine.1", f"{fu_f}/refine1")
    imp.cbam(f"{fu_t}.refine.2", f"{fu_f}/refine_cbam")

    # Decoder (frame_recovery.py:260-332).
    for i in (1, 2, 3, 4):
        imp.put(
            f"{fp}decoder/up{i}/kernel",
            _deconv(imp.take(f"{tp}decoder.up{i}.0.weight")),
        )
        imp.bn(f"{tp}decoder.up{i}.1", f"{fp}decoder/up{i}_bn")
    imp.conv(f"{tp}decoder.final.0", f"{fp}decoder/final")


def import_frame_recovery(
    sd: Mapping[str, Array], base_channels: int = 64
) -> Dict[str, Tree]:
    imp = _Importer(state_dict_to_numpy(sd))
    _import_recovery_into(imp, "", "", base_channels)
    return imp.finish()


def import_enhancement_engine(sd: Mapping[str, Array], config=None) -> Dict[str, Tree]:
    """EnhancementEngine state_dict → flax-shaped variables.

    ``config`` is the port's ``EngineConfig`` (its defaults are the
    reference's ``EnhancementConfig`` defaults).
    """
    cfg = config or EngineConfig()
    imp = _Importer(state_dict_to_numpy(sd))
    if cfg.frame_recovery_enabled:
        _import_recovery_into(imp, "frame_recovery", "frame_recovery",
                              cfg.recovery_base_channels)
    if cfg.super_resolution_enabled:
        if cfg.use_lightweight_sr:
            _import_lightweight_into(imp, "super_resolution", "super_resolution")
        else:
            _import_sr_into(imp, "super_resolution", "super_resolution",
                            cfg.sr_num_residual_blocks)
    imp.put("enhancement_strength",
            np.reshape(imp.take("enhancement_strength"), (1,)))
    return imp.finish()


def import_adaptive_engine(sd: Mapping[str, Array], config=None) -> Dict[str, Tree]:
    """AdaptiveEnhancementEngine state_dict → flax-shaped variables.

    The reference flattens the 8×8-pooled frame channel-first
    ((B, C, 8, 8) → c·64 + y·8 + x) while the port pools NHWC
    ((B, 8, 8, C) → y·8C + x·C + c); the first Linear's input columns are
    permuted accordingly so both MLPs see identical features.
    """
    sd = state_dict_to_numpy(sd)
    w1 = sd.pop("complexity_estimator.2.weight")  # (64, C*8*8) torch order
    b1 = sd.pop("complexity_estimator.2.bias")
    w2 = sd.pop("complexity_estimator.4.weight")
    b2 = sd.pop("complexity_estimator.4.bias")

    c = w1.shape[1] // 64
    # ours_col(y, x, ch) == torch_col(ch, y, x)
    perm = np.array(
        [ch * 64 + y * 8 + x for y in range(8) for x in range(8) for ch in range(c)]
    )
    engine_vars = import_enhancement_engine(sd, config)

    params = {
        "engine": engine_vars["params"],
        "complexity_fc1": {"kernel": _linear(w1[:, perm]), "bias": b1},
        "complexity_fc2": {"kernel": _linear(w2), "bias": b2},
    }
    out: Dict[str, Tree] = {"params": params}
    if "batch_stats" in engine_vars:
        out["batch_stats"] = {"engine": engine_vars["batch_stats"]}
    return out
