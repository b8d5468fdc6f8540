"""Checkpoints into the port: nerve_cl state dicts and ``train_baseline``'s.

nerve_cl (the PyTorch reference) is not in the repository, so each case
writes a state dict in nerve_cl's key names and layouts from seeded weights
with this file's own inverse of the import mapping (``nerve_cl_state_dict``:
OIHW, Conv3d, ConvTranspose2d's (in, out) layout with unflipped taps,
Linear's (out, in), the LFF as a 1 × 1 conv, BatchNorm's running
statistics and ``num_batches_tracked``). The JAX package's strict importer
(``nerve_tpu.models.import_torch``) must consume it whole and return those
weights, and the port's (``nerve_tpu_torch.models.import_torch``) the same
tree, exactly; the port's model loaded from it (``models.bridge``) is held
against the JAX model applied to JAX's import: parameters exact, outputs
within 1e-5 of max|ref| (float32, eval mode, 32 × 32 frames). The engine
at recovery base 8, SR 16 features and 2 RDBs with a mask; the adaptive
engine in "lightweight" mode (the lightweight net and the complexity head,
whose first Linear's columns the importer permutes); the SR net and the
lightweight net alone. An unknown key and a missing key each raise.

``python -m nerve_tpu_torch.enhance --torch-checkpoint`` serves a state
dict saved under ``"model_state_dict"`` as the facade loaded with it does;
``--sr-checkpoint`` loads what ``python -m nerve_tpu_torch.train_baseline``
saved into the engine's SR net and exits with the JAX script's message on a
mismatched configuration.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import enhancement_engine as jeng
from nerve_tpu.models import import_torch as jimp
from nerve_tpu.models import super_resolution as jsr
from nerve_tpu_torch import enhance, train_baseline
from nerve_tpu_torch.models import api, flax_variables, import_torch, load_flax_variables
from nerve_tpu_torch.models.bridge import _flatten
from nerve_tpu_torch.models.enhancement_engine import (
    AdaptiveEnhancementEngine,
    EnhancementEngine,
    EngineConfig,
)
from nerve_tpu_torch.models.super_resolution import LightweightSuperResolution, SuperResolutionNet
from test_torch_port_models import randomize
from test_torch_port_recovery import seeded_variables

REL = 1e-5
H = W = 32
CFG = dict(recovery_base_channels=8, sr_num_features=16, sr_num_residual_blocks=2)


# --------------------------------------------------------------------------- #
# The inverse mapping: flax-shaped variables → a nerve_cl state dict
# --------------------------------------------------------------------------- #
def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))


class _Exporter:
    def __init__(self, variables):
        self.params = _flatten(variables["params"])
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd = {}

    @staticmethod
    def _key(fp):
        return fp.replace("/", ".")

    def put(self, tk, value):
        assert tk not in self.sd, tk
        self.sd[tk] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    def p(self, fp):
        return self.params.pop(self._key(fp))

    def conv(self, tk, fp, bias=True):
        self.put(f"{tk}.weight", _conv(self.p(f"{fp}/kernel")))
        if bias:
            self.put(f"{tk}.bias", self.p(f"{fp}/bias"))

    def bn(self, tk, fp):
        self.put(f"{tk}.weight", self.p(f"{fp}/scale"))
        self.put(f"{tk}.bias", self.p(f"{fp}/bias"))
        self.put(f"{tk}.running_mean", self.stats.pop(self._key(f"{fp}/mean")))
        self.put(f"{tk}.running_var", self.stats.pop(self._key(f"{fp}/var")))
        self.sd[f"{tk}.num_batches_tracked"] = torch.tensor(7)

    def dwsep(self, tk, fp):
        self.put(f"{tk}.depthwise.weight", _conv(self.p(f"{fp}/depthwise/kernel")))
        self.put(f"{tk}.pointwise.weight", _conv(self.p(f"{fp}/pointwise/kernel")))
        self.bn(f"{tk}.bn", f"{fp}/BatchNorm_0")

    def residual_block(self, tk, fp):
        self.dwsep(f"{tk}.conv1", f"{fp}/conv1")
        self.put(f"{tk}.conv2.0.weight", _conv(self.p(f"{fp}/conv2_dw/kernel")))
        self.put(f"{tk}.conv2.1.weight", _conv(self.p(f"{fp}/conv2_pw/kernel")))
        self.bn(f"{tk}.conv2.2", f"{fp}/bn2")

    def cbam(self, tk, fp):
        self.put(f"{tk}.channel_attention.fc.0.weight",
                 self.p(f"{fp}/ChannelAttention_0/Dense_0/kernel").T)
        self.put(f"{tk}.channel_attention.fc.2.weight",
                 self.p(f"{fp}/ChannelAttention_0/Dense_1/kernel").T)
        self.put(f"{tk}.spatial_attention.conv.weight",
                 _conv(self.p(f"{fp}/SpatialAttention_0/conv_kernel")))

    def temporal_conv3d(self, tk, fp):
        for part in ("spatial", "temporal"):
            self.put(f"{tk}.{part}.0.weight",
                     np.transpose(self.p(f"{fp}/{part}/kernel"), (4, 3, 0, 1, 2)))
            self.bn(f"{tk}.{part}.1", f"{fp}/{part}_bn")

    def sr(self, tp, fp, blocks):
        self.conv(f"{tp}feature_extractor.head.0", f"{fp}feature_extractor/head")
        for i in range(3):
            self.dwsep(f"{tp}feature_extractor.body.{i}", f"{fp}feature_extractor/body{i}")
        for i, j in enumerate((0, 2, 4, 6)):
            self.conv(f"{tp}motion_estimator.flow_net.{j}", f"{fp}motion_estimator/flow{i}")
        for i, j in enumerate((0, 2, 4)):
            self.conv(f"{tp}temporal_aggregator.attention.{j}",
                      f"{fp}temporal_aggregator/attn{i}")
        self.cbam(f"{tp}temporal_aggregator.refine", f"{fp}temporal_aggregator/refine")
        for b in range(blocks):
            for i in range(5):
                self.put(f"{tp}residual_blocks.{b}.layers.{i}.0.weight",
                         _conv(self.p(f"{fp}rdbs/rdb{b}_dense{i}_kernel")))
                self.put(f"{tp}residual_blocks.{b}.layers.{i}.0.bias",
                         self.p(f"{fp}rdbs/rdb{b}_dense{i}_bias"))
            self.put(f"{tp}residual_blocks.{b}.lff.weight",
                     self.p(f"{fp}rdbs/rdb{b}_lff_kernel").T[:, :, None, None])
            self.put(f"{tp}residual_blocks.{b}.lff.bias", self.p(f"{fp}rdbs/rdb{b}_lff_bias"))
        self.conv(f"{tp}gff.0", f"{fp}gff")
        self.conv(f"{tp}upsampler.conv", f"{fp}upsampler/conv")

    def lightweight(self, tp, fp):
        self.conv(f"{tp}net.0", f"{fp}head")
        for i in range(4):
            self.dwsep(f"{tp}net.{i + 2}", f"{fp}body{i}")
        self.conv(f"{tp}net.6", f"{fp}tail")

    def recovery(self, tp, fp):
        se_t, se_f = f"{tp}spatial_encoder", f"{fp}spatial_encoder"
        self.conv(f"{se_t}.stem.0", f"{se_f}/stem", bias=False)
        self.bn(f"{se_t}.stem.1", f"{se_f}/stem_bn")
        for i in range(2):
            self.residual_block(f"{se_t}.stage1.{i}", f"{se_f}/stage1_block{i}")
        for s in (2, 3):
            self.conv(f"{se_t}.stage{s}.0.0", f"{se_f}/stage{s}_down", bias=False)
            self.bn(f"{se_t}.stage{s}.0.1", f"{se_f}/stage{s}_down_bn")
            for i in range(2):
                self.residual_block(f"{se_t}.stage{s}.{i + 1}", f"{se_f}/stage{s}_block{i}")
        self.cbam(f"{se_t}.attention", f"{se_f}/attention")
        for i in (1, 2, 3):
            self.temporal_conv3d(f"{tp}temporal_encoder.conv{i}", f"{fp}temporal_encoder/conv{i}")
        self.conv(f"{tp}fusion.align", f"{fp}fusion/align")
        self.conv(f"{tp}fusion.attention.0", f"{fp}fusion/attn0")
        self.conv(f"{tp}fusion.attention.2", f"{fp}fusion/attn1")
        for proj in ("spatial_proj", "temporal_proj"):  # constants in nerve_cl: no entry
            self.p(f"{fp}fusion/{proj}/kernel")
        self.residual_block(f"{tp}fusion.refine.0", f"{fp}fusion/refine0")
        self.residual_block(f"{tp}fusion.refine.1", f"{fp}fusion/refine1")
        self.cbam(f"{tp}fusion.refine.2", f"{fp}fusion/refine_cbam")
        for i in (1, 2, 3, 4):
            k = self.p(f"{fp}decoder/up{i}/kernel")
            self.put(f"{tp}decoder.up{i}.0.weight", np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
            self.bn(f"{tp}decoder.up{i}.1", f"{fp}decoder/up{i}_bn")
        self.conv(f"{tp}decoder.final.0", f"{fp}decoder/final")

    def done(self):
        assert not self.params and not self.stats, (sorted(self.params), sorted(self.stats))
        return self.sd


def nerve_cl_state_dict(variables, kind, cfg=None):
    """The nerve_cl state dict of flax-shaped ``variables`` of a ``kind``
    of model ("sr", "lightweight", "recovery", "engine", "adaptive")."""
    e = _Exporter(variables)
    if kind == "sr":
        e.sr("", "", cfg)
    elif kind == "lightweight":
        e.lightweight("", "")
    elif kind == "recovery":
        e.recovery("", "")
    else:
        pre = "engine/" if kind == "adaptive" else ""
        if kind == "adaptive":
            w1 = e.params.pop("complexity_fc1.kernel").T  # (64, 8·8·C), NHWC columns
            c = w1.shape[1] // 64
            perm = np.array([ch * 64 + y * 8 + x for y in range(8) for x in range(8)
                             for ch in range(c)])
            torch_w1 = np.empty_like(w1)
            torch_w1[:, perm] = w1
            e.put("complexity_estimator.2.weight", torch_w1)
            e.put("complexity_estimator.2.bias", e.params.pop("complexity_fc1.bias"))
            e.put("complexity_estimator.4.weight", e.params.pop("complexity_fc2.kernel").T)
            e.put("complexity_estimator.4.bias", e.params.pop("complexity_fc2.bias"))
        if any(k.startswith(pre.replace("/", ".") + "frame_recovery.") for k in e.params):
            e.recovery("frame_recovery.", f"{pre}frame_recovery/")
        if cfg.use_lightweight_sr:
            e.lightweight("super_resolution.", f"{pre}super_resolution/")
        else:
            e.sr("super_resolution.", f"{pre}super_resolution/", cfg.sr_num_residual_blocks)
        e.put("enhancement_strength", e.p(f"{pre}enhancement_strength"))
    return e.done()


def _constant_projections(variables, prefix, c):
    """The fusion's projections set to nerve_cl's 1/c channel mean."""
    node = variables["params"]
    for k in prefix:
        node = node[k]
    for proj in ("spatial_proj", "temporal_proj"):
        node["fusion"][proj]["kernel"] = np.full((1, 1, c, c), 1.0 / c, np.float32)


def _jax_apply(module, variables, *args, **kw):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, *a: module.apply(v, *a, **kw))(variables, *args))


def _assert_rel(got, ref, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, what
    d = np.abs(got - ref).max()
    assert d <= REL * np.abs(ref).max(), (what, d, np.abs(ref).max())


def _assert_same_tree(got, ref):
    got, ref = _flatten(got), _flatten(ref)
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k in ref:
        assert np.array_equal(np.asarray(got[k], np.float32), np.asarray(ref[k], np.float32)), k


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((1, 5, H, W, 3), np.float32)
    mask = np.zeros((1, H, W, 1), np.float32)
    mask[0, 6:20, 9:27] = 1.0
    return frames, mask


# --------------------------------------------------------------------------- #
# Importers
# --------------------------------------------------------------------------- #
def test_engine_state_dict_through_both_importers():
    frames, mask = _inputs()
    jcfg = jeng.EngineConfig(**CFG)
    jmod = jeng.EnhancementEngine(jcfg)
    args = (jnp.asarray(frames), None, jnp.asarray(mask))
    variables = seeded_variables(jmod, *args, seed=5)
    _constant_projections(variables, ("frame_recovery",), 4 * CFG["recovery_base_channels"])
    cfg = EngineConfig(**CFG)
    sd = nerve_cl_state_dict(variables, "engine", cfg)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    # JAX's strict importer consumes it whole and returns the seeded weights.
    jvars = jimp.import_enhancement_engine(sd, jcfg)
    jimp.validate_against(jvars, variables)
    _assert_same_tree(jvars, variables)
    tvars = import_torch.import_enhancement_engine(sd, cfg)
    _assert_same_tree(tvars, jvars)
    eng = load_flax_variables(EnhancementEngine(cfg, device="cpu"), tvars).eval()
    _assert_same_tree({"params": flax_variables(eng)["params"]}, {"params": jvars["params"]})
    ref = _jax_apply(jmod, jvars, *args)
    got = eng(torch.from_numpy(frames), None, torch.from_numpy(mask))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _assert_rel(got[k], ref[k], k)


def test_adaptive_engine_state_dict_through_both_importers():
    frames, _mask = _inputs(1)
    jcfg = jeng.EngineConfig(**CFG).with_mode("lightweight")
    jmod = jeng.AdaptiveEnhancementEngine(jcfg)
    variables = seeded_variables(jmod, jnp.asarray(frames), seed=6)
    cfg = EngineConfig(**CFG).with_mode("lightweight")
    sd = nerve_cl_state_dict(variables, "adaptive", cfg)
    jvars = jimp.import_adaptive_engine(sd, jcfg)
    _assert_same_tree(jvars, variables)
    tvars = import_torch.import_adaptive_engine(sd, cfg)
    _assert_same_tree(tvars, jvars)
    eng = load_flax_variables(AdaptiveEnhancementEngine(cfg, device="cpu"), tvars).eval()
    ref = _jax_apply(jmod, jvars, jnp.asarray(frames), 0.8, 0.7)
    got = eng(torch.from_numpy(frames), 0.8, 0.7)
    for k in ref:
        _assert_rel(got[k], np.asarray(ref[k], np.float32), k)


@pytest.mark.parametrize("kind", ["sr", "lightweight"])
def test_sr_state_dicts_through_both_importers(kind):
    frames, _mask = _inputs(2)
    if kind == "sr":
        jmod = jsr.SuperResolutionNet(num_features=16, num_residual_blocks=2)
        x = frames[:, 1:4]
        port = SuperResolutionNet(num_features=16, num_residual_blocks=2, device="cpu")
        sd_args, jimport = (2,), lambda sd: jimp.import_super_resolution(sd, 2)
        timport = lambda sd: import_torch.import_super_resolution(sd, 2)  # noqa: E731
    else:
        jmod = jsr.LightweightSuperResolution()
        x = frames[:, 2]
        port = LightweightSuperResolution(device="cpu")
        sd_args, jimport = (None,), jimp.import_lightweight
        timport = import_torch.import_lightweight
    variables = seeded_variables(jmod, jnp.asarray(x), seed=7)
    sd = nerve_cl_state_dict(variables, kind, *sd_args)
    jvars = jimport(sd)
    _assert_same_tree(jvars, variables)
    _assert_same_tree(timport(sd), jvars)
    model = load_flax_variables(port, timport(sd)).eval()
    _assert_rel(model(torch.from_numpy(x)), _jax_apply(jmod, jvars, jnp.asarray(x)), kind)


def test_importers_are_strict():
    frames, _mask = _inputs(3)
    jmod = jsr.LightweightSuperResolution()
    variables = seeded_variables(jmod, jnp.asarray(frames[:, 2]), seed=8)
    sd = nerve_cl_state_dict(variables, "lightweight")
    with pytest.raises(ValueError, match="unconsumed"):
        import_torch.import_lightweight({**sd, "net.9.weight": torch.zeros(3)})
    missing = dict(sd)
    del missing["net.6.bias"]
    with pytest.raises(KeyError, match="net.6.bias"):
        import_torch.import_lightweight(missing)
    tvars = import_torch.import_lightweight(sd)
    del tvars["params"]["tail"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(LightweightSuperResolution(device="cpu"), tvars)


# --------------------------------------------------------------------------- #
# The enhance CLI's checkpoints
# --------------------------------------------------------------------------- #
CLI_FLAGS = ["--sr-features", "16", "--sr-blocks", "1", "--device", "cpu", "--float"]


def _video(tmp_path):
    src = tmp_path / "in.npy"
    np.save(src, np.random.default_rng(9).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8))
    return src


def _run_cli(args, capsys):
    rc = enhance.main([str(a) for a in args])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_enhance_torch_checkpoint(tmp_path, capsys):
    cfg = EngineConfig(sr_num_features=16, sr_num_residual_blocks=1)
    source = EnhancementEngine(cfg, device="cpu")
    variables = randomize(flax_variables(source), 3)  # no zero-initialised layer
    c = 4 * cfg.recovery_base_channels
    _constant_projections(variables, ("frame_recovery",), c)
    sd = nerve_cl_state_dict(variables, "engine", cfg)
    ckpt = tmp_path / "engine.pth"
    torch.save({"model_state_dict": sd, "epoch": 3}, ckpt)
    src, dst, masks = _video(tmp_path), tmp_path / "out.npy", tmp_path / "m.npy"
    m = np.zeros((3, 1, 16, 24), np.float32)
    m[1, :, 4:9, 5:14] = 1
    np.save(masks, m)
    summary = _run_cli([src, "-o", dst, "--masks", masks, "--torch-checkpoint", ckpt,
                        *CLI_FLAGS], capsys)
    assert summary["output_shape"] == [3, 3, 32, 48] and summary["launches"] == {}
    facade = api.EnhancementEngine(cfg, device="cpu", seed=11)
    facade.load_variables(import_torch.import_enhancement_engine(sd, cfg))
    want = facade.enhance_video(np.moveaxis(np.load(src), -1, 1), m)
    np.testing.assert_array_equal(np.load(dst), want.numpy())
    fresh = tmp_path / "fresh.npy"
    _run_cli([src, "-o", fresh, "--masks", masks, *CLI_FLAGS], capsys)
    assert not np.array_equal(np.load(fresh), np.load(dst))  # the weights were used


def test_enhance_sr_checkpoint_round_trip_and_mismatch(tmp_path, capsys):
    ck = tmp_path / "ck"
    train_baseline.main(["--device", "cpu", "--epochs", "1", "--train-samples", "4",
                         "--val-samples", "2", "--lr-size", "16", "--num-features", "8",
                         "--num-blocks", "1", "--batch-size", "2", "--checkpoint-dir", str(ck)])
    capsys.readouterr()
    saved = torch.load(ck / "step_1.pt", map_location="cpu", weights_only=True)
    eng = api.EnhancementEngine(EngineConfig(sr_num_features=8, sr_num_residual_blocks=1),
                                device="cpu")
    enhance.load_sr_checkpoint(eng.engine, str(ck))
    sr = eng.engine.super_resolution
    for k, p in sr.named_parameters():
        assert torch.equal(p, saved["params"][k]), k
    stats = {k: v for k, v in sr.state_dict().items() if k.endswith((".mean", ".var"))}
    assert stats and all(torch.equal(v, saved["batch_stats"][k]) for k, v in stats.items())
    src, dst = _video(tmp_path), tmp_path / "out.npy"
    flags = ["--sr-features", "8", "--sr-blocks", "1", "--device", "cpu", "--mode", "sr_only"]
    summary = _run_cli([src, "-o", dst, "--sr-checkpoint", ck, *flags], capsys)
    assert summary["output_shape"] == [3, 3, 32, 48]
    with pytest.raises(SystemExit, match="don't match the engine's SR subtree"):
        enhance.main([str(src), "-o", str(dst), "--sr-checkpoint", str(ck), *CLI_FLAGS])
