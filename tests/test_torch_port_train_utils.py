"""The port's training utilities against the JAX package's, on the CPU.

(4) The learning-rate schedule against ``optax.warmup_cosine_decay_schedule``
as ``create_optimizer`` builds it, evaluated at optax's int32 update count,
for 50 steps with and without warm-up, and the constant schedule: within
one float32 ulp (the port evaluates it in float32 in optax's order, its
cosine correctly rounded; optax's eager float32 cosine is one ulp off at
count 26 of the run without warm-up, 1.007e-7 relative). (5)
``psnr``, ``ssim``, ``ms_ssim`` and ``vmaf_proxy`` against JAX's at 1e-5
relative (``ms_ssim`` of two unrelated images, 0.06, at 1e-5 absolute:
measured 1.6e-6, a sum that cancels).
(6) ``batches`` draws the JAX function's indices for the same generator,
``expand_temporal`` is equal, LR is the box mean of HR to the bit, and the
cubic resize of the synthetic images is ``jax.image.resize``'s. (7) The
port's default config equals ``config_to_dict(nerve_tpu.load_config())``.
Also the checkpoint manager's keep-last-N and refusals, and the global-norm
clipping against ``optax.clip_by_global_norm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerve_tpu import load_config as jax_load_config
from nerve_tpu.config.schema import TrainingConfig as JaxTrainingConfig
from nerve_tpu.config.schema import config_to_dict as jax_config_to_dict
from nerve_tpu.utils import data as jdata
from nerve_tpu.utils import metrics as jmetrics
from nerve_tpu_torch import training
from nerve_tpu_torch.config import config_to_dict, load_config
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.utils import data, metrics
from nerve_tpu_torch.utils.checkpoint import CheckpointManager

SCHEDULES = {
    "warmup": dict(epochs=5, warmup_epochs=1, learning_rate=3e-4),
    "no_warmup": dict(epochs=5, warmup_epochs=0, learning_rate=3e-3),
    "constant": dict(epochs=5, warmup_epochs=1, learning_rate=1e-4, scheduler="constant"),
}


def _optax_schedule(cfg, steps_per_epoch):
    """The schedule ``nerve_tpu.training.create_optimizer`` hands to optax."""
    total = max(1, cfg.epochs * steps_per_epoch)
    warmup = min(cfg.warmup_epochs * steps_per_epoch, total - 1)
    if cfg.scheduler != "cosine":
        return lambda count: cfg.learning_rate
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else cfg.learning_rate, peak_value=cfg.learning_rate,
        warmup_steps=warmup, decay_steps=total, end_value=cfg.learning_rate * 0.01)


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedule_matches_optax(name):
    steps_per_epoch = 9  # 45 updates: the 50 counts run past the end
    ref = _optax_schedule(JaxTrainingConfig(**SCHEDULES[name]), steps_per_epoch)
    got = training.lr_schedule(TrainingConfig(**SCHEDULES[name]), steps_per_epoch)
    for count in range(50):
        want = float(np.asarray(ref(jnp.int32(count)), np.float32))
        assert abs(got(count) - want) <= np.spacing(np.float32(abs(want))), (count, got(count),
                                                                           want)
    if name == "warmup":
        assert got(0) == 0.0 and got(9) == float(np.float32(3e-4))
    if name != "constant":
        assert got(49) == float(np.float32(SCHEDULES[name]["learning_rate"] * 0.01))


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = training.clip_by_global_norm_(got, max_norm)
        assert abs(float(norm) - float(optax.global_norm(grads))) <= 1e-6 * float(norm)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_metrics_match_jax():
    pred = _images(1, (2, 48, 40, 3))
    target = np.clip(pred + 0.05 * _images(2, pred.shape) - 0.025, 0, 1).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    levels = metrics.msssim_levels_for(48, 40)
    assert levels == jmetrics.msssim_levels_for(48, 40) == 2
    jax_all = jax.jit(lambda p, t: (jmetrics.psnr(p, t), jmetrics.ssim(p, t),
                                    jmetrics.ms_ssim(p, t, levels=levels),
                                    jmetrics.vmaf_proxy(p, t, levels=levels), jmetrics.mse(p, t)))
    refs = jax_all(jnp.asarray(pred), jnp.asarray(target))
    ours = (metrics.psnr(tp, tt), metrics.ssim(tp, tt), metrics.ms_ssim(tp, tt, levels=levels),
            metrics.vmaf_proxy(tp, tt, levels=levels), metrics.mse(tp, tt))
    for name, got, ref in zip(("psnr", "ssim", "ms_ssim", "vmaf_proxy", "mse"), ours, refs):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=name)
    assert float(metrics.vmaf_proxy(tp, tp, levels=levels)) == pytest.approx(100.0, abs=1e-4)
    # An odd size pools with the floor, as reduce_window's VALID does.
    odd = _images(3, (1, 45, 47, 1))
    np.testing.assert_allclose(
        float(metrics.ms_ssim(torch.from_numpy(odd), torch.from_numpy(odd[:, ::-1].copy()),
                              levels=2)),
        float(jmetrics.ms_ssim(jnp.asarray(odd), jnp.asarray(odd[:, ::-1]), levels=2)),
        rtol=0, atol=1e-5)


def test_batches_and_expand_temporal_match_jax():
    d = {"lr": np.arange(11 * 2).reshape(11, 2), "hr": np.arange(11)}
    for drop in (True, False):
        got = list(data.batches(d, 4, rng=np.random.default_rng(7), drop_remainder=drop))
        ref = list(jdata.batches(d, 4, rng=np.random.default_rng(7), drop_remainder=drop))
        assert len(got) == len(ref) == (2 if drop else 3)
        for a, b in zip(got, ref):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert [b["hr"].tolist() for b in data.batches(d, 5)] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    lr = _images(4, (2, 5, 6, 3))
    np.testing.assert_array_equal(data.expand_temporal(torch.from_numpy(lr), 3).numpy(),
                                  np.asarray(jdata.expand_temporal(jnp.asarray(lr), 3)))


def test_datasets_box_decimation_and_resize():
    g = torch.Generator().manual_seed(0)
    sr = data.make_sr_dataset(g, 3, lr_size=8, scale=2)
    assert sr["lr"].shape == (3, 8, 8, 3) and sr["hr"].shape == (3, 16, 16, 3)
    box = sr["hr"].astype(np.float64).reshape(3, 8, 2, 8, 2, 3).mean(axis=(2, 4))
    np.testing.assert_array_equal(sr["lr"], box.astype(np.float32))
    assert 0.0 <= sr["hr"].min() and sr["hr"].max() <= 1.0 and sr["hr"].std() > 0.05
    vid = data.make_video_sr_dataset(g, 4, lr_size=8, scale=2, num_frames=3, max_shift=2)
    assert vid["lr_win"].shape == (4, 3, 8, 8, 3) and vid["hr"].shape == (4, 16, 16, 3)
    np.testing.assert_array_equal(
        vid["lr_win"][:, 1],
        vid["hr"].astype(np.float64).reshape(4, 8, 2, 8, 2, 3).mean(axis=(2, 4)).astype(
            np.float32))
    assert not np.array_equal(vid["lr_win"][:, 0], vid["lr_win"][:, 2])  # the frames move
    noise = np.random.default_rng(5).standard_normal((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        data.resize_cubic(torch.from_numpy(noise), 16).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(noise), (2, 16, 16, 3), "cubic")),
        rtol=0, atol=1e-6)


def test_default_config_matches_jax():
    ours, ref = config_to_dict(load_config()), jax_config_to_dict(jax_load_config())
    assert ours == ref
    over = load_config(overrides={"training.batch_size": 8})
    assert over.training.batch_size == 8 and over.model.compute_dtype == "bfloat16"
    with pytest.raises(KeyError):
        load_config(overrides={"training.nope": 1})


def test_config_json_file(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text('{"training": {"epochs": 3, "optimizer": "sgd"}}')
    cfg = load_config(str(path))
    assert cfg.training.epochs == 3 and cfg.training.optimizer == "sgd"
    assert isinstance(training.create_optimizer(cfg.training, [torch.nn.Parameter(
        torch.zeros(2))]).torch_opt, torch.optim.SGD)


def test_checkpoint_manager_keep_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore_raw()
    for step in (1, 2, 3):
        assert mgr.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert not mgr.save(3, {"w": torch.zeros(2), "step": 3})
    state = mgr.restore({"w": None, "step": None}, step=2)
    assert state["step"] == 2 and torch.equal(state["w"], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="best_psnr"):
        mgr.restore({"w": None, "best_psnr": None})
    assert not list((tmp_path / "ck").glob("*.tmp"))
