"""Drive the PyTorch port's SR serving paths once on an NVIDIA GPU.

    python3 chip_smoke.py              # the checks below, ~6-7 min on an H100 with the build
    python3 chip_smoke.py --profile build/traces   # also profile the three slices

Phases, each of which raises on failure and prints its wall time:

1. Build: ``nvcc`` compiles ``nerve_tpu_torch/csrc`` for ``sm_90a``; the
   dense-convolution, RDB-fusion and ``rdb_taps`` kernels' SASS must hold
   warpgroup products and no ``mma.sync`` products: ``HGMMA`` and no
   ``HMMA`` for the bf16 layer, fusion and ``rdb_taps`` layer, ``IGMMA``
   and no ``IMMA`` for the int8 layer and fusion, each instance printed
   with its ptxas registers and spills.
2. Device: the probe of ``diag.probe`` (a matrix product and the probe
   kernel), then the card's name and power limit (``nvidia-smi``); TF32 off;
   the host cost of one launch through ``_build.launch`` and the probe's
   wrapper beside ``a * 2.0`` (``diag.planar.launch_path``: host clock over
   10,000 launches without a synchronise).
3. Kernels: each of the eleven CUDA kernels against its plain PyTorch version
   on the card, at a small ragged shape and at the serving shapes of the
   flagship path (1080p → 2160p) and, for the depthwise layer and the planar
   chain, of the lightweight body at 1080p (the planar chain with its weight
   pack made beforehand, and once more packing in the call), with median
   times from CUDA events, the
   least time the card could take for the same work (``bound_ms``) and,
   where one PyTorch call computes the same function, that call's time
   (``library_ms``). The bf16 kernels run in bfloat16 and float32; the int8
   kernels take scales calibrated on their own inputs and are bit-exact,
   the int8 RDB also in its three tap schedules over many tiles per block
   at a ragged shape; the input quantisation (``quantize_i8``) is bit-exact
   on values at and next to (k + 0.5)·s, at a scale where x · (1 / s)
   would round some of them otherwise, and past ±127; its serving shape is the
   attention site's three 64-channel frames. The RDB fusions also run alone
   (``rdb_lff``, ``rdb_lff_i8``: 224 → 64 channels at 1080p; at the small
   shape from a wider buffer into an offset slot; in float32 the dense
   layers and fusion run the implicit-GEMM family of ``csrc/conv_f32.cuh``,
   ``conv_f32`` / ``rdb_lff_f32``), the int8 one bit-exact
   on values at .5 steps of the next block's scale; their library times
   are ``torch.matmul`` and ``torch._int_mm`` of the same products. The
   correlation also runs the exact-sum input at the serving shape
   (``diag.correlation.exact_sum_inputs``: bit-exact, which a kernel that
   does not round each product to bfloat16 fails). Its ``bound_ms`` is by
   bytes: its multiplies and adds at the card's bfloat16 peak take less.
   Beside it are printed two least times of the kernel's own design, which
   does all its work on the CUDA cores: a multiply and an add per product at
   the float32 peak, and the issue rate of its 2.5 instructions a product.
   The int8 kernels' library
   time is ``torch._int_mm``'s for the same int32 products (products only,
   ``diag.conv.int_mm_yardstick``). Then the bf16 dense
   convolution per conv-chain site and per dense layer of one RDB block,
   each beside cuDNN and its own bound (``diag.conv``, one ``{"conv"}``
   line). The depthwise layer also runs wider than one 64-channel slice (C
   = 96, 128, 200) on both routes and in both dtypes, and the planar chain
   (the lightweight body) on frames holding one +Inf, one -Inf and one NaN:
   its output must be not finite exactly where its plain version's is, its
   finite values within the chain's limit. Last, the launch records of the
   depthwise layer (32 and 128 channels), both d2s kernels (the planar one
   also at odd widths with s = 3, 4) and the bf16 ``rdb_taps`` layer under
   each contract (cin 192, and 384 at growth 64).
4. bf16 slice: ``SuperResolutionNet`` (64 features, 8 RDBs, temporal window
   1, flow at half resolution, bfloat16) with seeded weights, primed on
   frame 0 of a seeded 1080×1920 video and stepped with
   ``streaming_step(..., "packed")``. Every bf16 kernel's launch counter must
   grow in that run (8 ``rdb`` and 8 ``rdb_lff`` per step). The same frames
   then run with the plain versions on the card, and the two outputs must
   agree.
5. int8 slice: the same seeded model built with ``quantized=True,
   quantized_chains=True``, calibrated by ``quantize_sr`` on a (1, 3, 270,
   480, 3) crop of the video, then streamed the same way. ``rdb_int8``,
   ``conv_chain_int8``, ``quantize_i8``, ``correlation`` and ``d2s_packed``
   must launch (10 ``conv_chain_int8``, 8 ``rdb_int8``, 8 ``rdb_lff_i8`` and
   6 ``quantize_i8`` per step, one more head and quantisation for the
   prime) and ``rdb``, ``rdb_lff`` and ``conv_chain`` must not; each of the
   six int8 states must pack its
   weights once in the run (no frame after the first packs); the output
   must agree with the int8 plain
   versions' and lie within ``INT8_MIN_PSNR`` dB of the bf16 slice's.
6. Diagnostic paths: (a) the kernels of the diagnostic entry points
   (``nerve_tpu_torch.diag``) against their plain versions: the int8 RDB's
   per-channel ``int32_taps`` and dx-major schemes (bit-exact), the RDB
   under each TPU rounding contract and its ablations (``ops.rdb_taps``;
   in bfloat16 a contract's mean|Δ| against its own plain version must be
   at most ¼ of that against any other contract's), the planar d2s (also
   at odd widths with s = 3, 4) and the probe kernel, at a small ragged
   shape in float32 and bfloat16, with every contract also over many tiles
   at 1 × 131 × 517 × 64 and in a block of 128 features and growth 64 (cin
   up to 384), and at the serving shapes (every contract and the ``noshift``
   and ``nolff`` ablations at 1080p × 64);
   (b) the int8 slice once more with ``rdb_int8.PER_CHANNEL_INT8 = True``
   and the model built inside ``torch.inference_mode()`` (the same checks):
   ``rdb_int8_int32_taps`` must launch, the output must agree with its
   plain run at the int8 limits and lie within ``INT8_MIN_PSNR`` dB of the
   bf16 slice's; (c) the RDB cost-attribution table of ``diag.rdb`` (one
   block at 1080p × 64) and the d2s candidates of ``diag.d2s``.
7. Lightweight slice: an untrained ``LightweightSuperResolution`` (zero
   tail) must return the clipped bicubic upscale within 2⁻⁸; then the model
   with every parameter and BN statistic seeded, in bfloat16, runs frame by
   frame over the same video with ``"packed"`` output. ``conv_chain``,
   ``conv_chain_dw3`` and ``d2s_packed`` must launch (6, 4 and 1 per frame),
   the flagship's other kernels must not, and the output must agree with
   the plain versions' run. Last, the same body runs through
   ``ops.planar_chain_apply`` (the one-launch planar chain) on each planar
   frame: ``planar_chain`` must launch once per frame and nothing else, and
   its result must agree with the per-layer body's. Both bodies take the
   model's chain folded once, the planar one its pack made once.

8. Engine: the channel-first facade's ``EnhancementEngine`` in bfloat16 at
   the full configuration (recovery base 64, window 2; SR 64 features, 8
   RDBs, window 1, flow at half resolution), every weight seeded, strength
   1, on a seeded uint8 (1, 5, 3, 1080, 1920) window with a (1, 1, 1080,
   1920) mask over a 270 x 480 block: the keys and shapes of ``recovered``,
   ``super_resolved`` and ``enhanced`` (2160 x 3840), finite values,
   ``enhanced`` in [0, 1], ``recovered`` the input exactly outside the
   mask; the launches of one call (8 ``rdb``, 8 ``rdb_lff``, a
   ``correlation``, ``conv_chain``); the same engine through the plain
   versions (max|Δ| ≤ 2e-2, mean ≤ 5e-4); ms per call in each mode
   ("full", "sr_only", "recovery_only", "lightweight"; median of 3 after
   one untimed call); ``enhance_video`` over 6 masked frames at 540 × 960,
   uint8 out, frames per second; ``streaming_step_pair`` against two
   ``streaming_step`` calls at the slice's limits, ms of each; then
   ``quantize_int8(chains=True)`` (calibrated on a 540 × 960 crop): the
   int8 kernels launch, ``rdb``, ``rdb_lff`` and ``conv_chain`` do not, six
   weight packs, PSNR against the bf16 engine ≥ ``INT8_MIN_PSNR``, ms per
   call in "full" and "sr_only"; the adaptive engine at budgets 0.2, 0.5,
   0.9 (modes "lightweight", "sr_only", "full", complexity in [0, 1],
   strength in [0.3, 1]); and ``python -m nerve_tpu_torch.enhance`` as a
   subprocess on 4 uint8 frames at 270 × 480 (exit 0, its JSON line read).

9. Train: the flagship's training path. (a) Each kernel op of the
   training forward at the training shapes (batch 16, LR 64 × 64, 64
   features; ``diag.train.grad_cases``) in float32 (TF32 off) and bfloat16:
   the attention chain on its list of three frames, the 8-block RDB stack,
   the correlation on the 32 neighbour pairs, the warp; the op as the model
   calls it (an autograd Function: the kernels forward, the vjp of the
   plain version backward) against plain autograd through the plain
   version, with the same inputs, weights and upstream gradient: the output
   and each gradient within ``TRAIN_LIMITS`` of max|plain|, max and mean
   |Δ| printed, the kernels launched. (b) The flagship train step (64/8,
   window 1, bfloat16 compute, float32 master weights, AdamW; seeded
   weights; batch 16, 64² → 128² panning windows of
   ``make_video_sr_dataset``) for ``TRAIN_STEPS`` steps: each step's
   forward launches 10 ``conv_chain``, 8 ``rdb``, 8 ``rdb_lff`` and 1
   ``correlation`` and nothing else; the same steps from the same weights
   and batches with the plain versions launch nothing; the losses within
   ``TRAIN_LOSS_REL``, the parameters within ``TRAIN_PARAM_REL`` of the
   largest parameter change (max|Δ|) and ``TRAIN_PARAM_L2`` (L2); ms per
   step (median of 20 after 3 untimed), samples/s, peak memory. (c)
   ``training.fit_sr`` on a seeded ``make_video_sr_dataset`` (64 train, 16
   val), 3 epochs at lr 3e-3 without warm-up, from the model's own
   initialisation: every loss finite, the last epoch's mean below the
   first's. (d) The train state after (b) saved by
   ``utils.checkpoint.CheckpointManager`` and restored into a fresh model
   and optimiser: its next step's loss equals the uninterrupted run's to
   the bit. (e) ``python -m nerve_tpu_torch.train_baseline`` (1 epoch, 32
   train and 16 val samples, 64/8) as a subprocess: exit 0, its last line
   ``{"best_psnr", "final_psnr"}``.

10. Continual: the continual-learning pillar (``nerve_tpu_torch.continual``).
   (a) Each kernel op's Hessian-vector product ∂/∂(inputs, g) ⟨∂⟨op, g⟩/∂inputs,
   v⟩ (``create_graph=True``; ``diag.continual.compare_hvp``) as the model
   calls the op and through its plain version, in float32 and bfloat16 at
   ``TRAIN_LIMITS``, at the small shapes of ``diag.train.grad_cases`` and at
   the continual experiment's widths (16 features, 2 RDBs of growth 32, LR
   32², batch 16), where the first-order gradients and the forward are held
   too: every second derivative the plain version has must be there and
   nonzero. (b) The continual library at the flagship's width (64 features,
   8 RDBs, window 3, LR 64², batch 4, float32, BatchNorm held;
   ``diag.continual.library_run``) on the kernel route and on the plain
   route (``plain_ops()``): EWC's batch Fisher (2 batches), per-sample Fisher
   (1 batch), penalty and a penalised Adam step, an SI step and its
   importances, a replay step, a second-order MAML step and a first-order
   one (2 tasks × 1 inner step), a Reptile step and
   ``ContinualDistillation.compute_loss``: each loss, Fisher, importance and
   meta-gradient within ``CONTINUAL_L2`` in relative L2 norm, the
   parameters after each step at ``TRAIN_PARAM_REL``/``TRAIN_PARAM_L2``; the
   second-order step launches ``conv_chain``, ``rdb``, ``rdb_lff``,
   ``correlation`` and the float32 family's ``conv_f32`` and
   ``rdb_lff_f32`` (the plain route nothing), and its meta-gradient differs
   from the first-order one by more than ``CONTINUAL_L2`` (the size of a
   dropped second-order term); ms per meta step and per Fisher pass, peak
   memory. (c) ``python -m nerve_tpu_torch.train_continual`` once per
   strategy (``ewc``, ``replay``, ``si``, ``maml``, ``reptile``; 2 tasks, 1
   epoch, 16 samples, batch 8), the five as parallel subprocesses: exit 0,
   finite PSNRs in the last line.
11. Federated: the federated pillar (``nerve_tpu_torch.federated``) on the
   lightweight model, float32, TF32 off (``diag.federated``). (a) Its train
   step (live BatchNorm) and its frozen-statistics step (the eval forward on
   the tape, ``differentiable=True``), every parameter and statistic seeded,
   batch 8 at LR 16² and 64²: the output, loss, every gradient and every new
   running statistic on the kernel route against the plain route
   (``diag.federated.plain_route()``): outputs, losses and statistics within
   ``FED_LIMIT`` of max|plain|, the gradients together within
   ``FED_GRADS_L2`` in relative L2 and each within ``FED_GRAD_TENSOR``; the launches of one
   step exactly ``FED_STEP_LAUNCHES`` (train 2 ``conv_chain``, each a
   ``conv_f32``; frozen 6 ``conv_chain`` / ``conv_f32`` and 4
   ``conv_chain_dw3``; each backward none); 5 AdamW
   steps of a ``VideoEnhancementClient`` on both routes, the parameters at
   phase 9's rule. (b) One FedAvg round of the CLI's data (8 clients × 5
   local steps, 32 samples at LR 16²) on both routes: the parameters at
   phase 9's rule, ``update_norm`` within ``FED_NORM_REL``, the launches of
   the round (40 steps' forwards), the plain route none; with DP clipping at
   half the smallest client delta's norm, every clipped delta's norm at most
   C and the largest at C. (c) ``python -m nerve_tpu_torch.train_federated``
   in its four modes as parallel subprocesses: ``simulation`` at the
   defaults (a finite ``final_loss``, client 0's loss lower after round 5
   than after round 1), ``trainer`` at 2 rounds (a finite ``final_loss``),
   ``server`` at 1 round with two ``client`` processes on ``127.0.0.1`` (the
   server's round line with a finite ``train_loss``); any child failing
   fails the phase, and every child is killed at the end. (d) ms per round
   at the CLI's defaults and its launches, ms per client ``fit`` (1 epoch,
   batch 8, 32 samples) at LR 16² and 64², the 64² fit's peak memory. (e)
   The float32 route of the conv chain (``diag.federated.float32_layers``:
   the lightweight head 3 -> 32 and tail 32 -> 12, 64 -> 64 and ``dw3``, at
   8 × 64² and 1080p) beside its plain version, cuDNN and its bound: each
   one launch of its kernel and within ``FLOAT32_ROW_REL`` of max|plain|,
   or the run fails.
12. Recovery and checkpoints (``diag.recovery``; float32, TF32 off). (a) One
   recovery train step (``training.recovery``: base 64, window 2, T = 5,
   batch 8, 64², seeded weights, the protocol's masks) on the card against
   the same step on the CPU from the same weights and batch: the loss
   within ``RECOVERY_LOSS_REL``, the running statistics within
   ``RECOVERY_STAT_REL`` of max|CPU|, each gradient within
   ``RECOVERY_GRAD_L2`` in relative L2 or, over that, no farther from the
   same step in float64 on the card than the CPU's. (b) 20 AdamW steps over
   fresh batches: the loss falls (the mean of the last 5 under the first
   5's); ms per step (host clock, median of 10 after 3), CUDA-event ms
   per step over 10 chained steps (``utils.profiling.timed_chain``), peak
   memory, and the hand-written
   kernels' launches per step, which stay 0 (the net is plain
   ATen/cuDNN). (c) ``python -m nerve_tpu_torch.recovery_protocol`` at 1
   epoch, 48/16 samples: its JSON line parses and its masked PSNR beats
   zero-fill at every fraction. (d) The seeded bf16 engine's weights
   written as a nerve_cl state dict by this script's own inverse of the
   import mapping (``NerveClExport``), read back bit-exactly by
   ``models.import_torch``, then ``python -m nerve_tpu_torch.enhance
   --torch-checkpoint`` on 3 uint8 1080p frames with masks, 2160p out
   through the kernels (24 ``rdb``, its launches printed). (e) ``python -m
   nerve_tpu_torch.train_baseline`` (64/8, 1 epoch at LR 32²) writes a
   checkpoint that ``enhance --sr-checkpoint`` serves (``sr_only``) and
   that loads into the facade's SR net exactly; with 4 RDBs the CLI exits
   non-zero with the mismatch message. (g) The int8 engine's SR net
   (``quantize_int8(chains=True)``) in ``.train()``: no
   ``conv_chain_int8``, 8 ``rdb_int8``, the chain sites on ``conv_chain``,
   the output against the plain route's at the int8 limits; (f) its
   ``streaming_step_pair`` against two ``streaming_step``s at the int8
   limits. (h) The BatchNorm scale and bias
   gradients of phase 9's bf16 train step and of phase 11's float32 train
   step at 64², on the kernel route and on the plain route, each against
   the plain route in float64: the kernel route's worst error within 2× of
   the plain route's. The CLIs (c)-(e) run as subprocesses beside (a), (b),
   (g), (f), (h). Phase 10 also prints the float32 route's times at the
   meta step's shapes (``diag.continual.float32_rows``: the head, 64 -> 64,
   an RDB block, the fusion alone at 4 × 64² and 1080p, the correlation),
   each held to ``FLOAT32_ROW_REL`` of max|plain|. The kernels phase also
   runs the planar chain on finite inputs whose second layer overflows
   bfloat16 (``diag.planar.overflow_case``, widths 32 and 20): the kernel's
   NaN / +Inf / -Inf where the plain version's are; and prints the float32
   family's launch records. The ``{"kernels"}`` line's ``conv_f32`` and
   ``rdb_lff_f32`` entries take their launches from phase 10's meta step and
   their times from the 64 -> 64 row at 1080p and the fusion's 1080p row.
13. ABR and MLOps (``nerve_tpu_torch.abr``, ``train_abr``,
   ``nerve_tpu_torch.mlops``; ``diag.abr``; float32, TF32 off; plain
   PyTorch, as the JAX package's ABR and MLOps code reaches no Pallas
   kernel). (a) ``TorchStreamingEnv`` over 4096 streams for 128 steps with
   auto-resets, the draws and actions made once on the CPU and fed to the
   card and to the CPU: observations, rewards and the final state within
   ``diag.abr.ENV_LIMIT`` of max|CPU|, ``done`` equal; ms per step. (b) One
   PPO update at ``ABRConfig()`` defaults (256 x 256, 2048 transitions of a
   CPU rollout of 16 streams flattened t-major, 10 epochs) on the card and
   on the CPU from the same parameters: each parameter's change, Adam's
   moments and count and the four metrics at ``diag.abr``'s limits; ms per
   update (median of 5 after 1). (c) ``python -m nerve_tpu_torch.train_abr
   --vectorized`` (16 streams x 128 steps an iteration, 4 iterations) as a
   subprocess: finite losses, the checkpoint's parameters moved from the
   seed's, ms per iteration split into rollout and update; then ``--mode
   eval`` on its checkpoint (``train_abr.main``): finite ``mean_return``,
   ``mean_vmaf``, ``mean_rebuffer``. (d) The sequential loop for 256 steps
   (``StreamingEnv`` in numpy, one ``select_action`` a step): an update at
   an episode's end with a finite loss; ms per ``select_action`` and per
   update. (e) ``DriftDetector("mmd")`` on
   1000 x 64 reference and window samples, unshifted and shifted by 1, on
   the card and on the CPU: scores within ``diag.abr.DRIFT_REL``, decisions
   equal (no drift, drift); ms per ``detect``.

``--profile DIR`` profiles two steps of each slice, and two bf16 engine
calls in "full" and in "recovery_only" mode (``diag.conv.profile``:
idle share, kernels by time, the RDB fusions', dense layers' and ATen
copies' time and launches per step), and two train steps
(``diag.train.profile_split``: device ms per step of the forward's
kernels, the forward's ATen work, the backward's recompute of the plain
versions, the rest of the backward and the optimiser), and two recovery
train steps (``diag.recovery.profile_step``: device ms by part and by
kernel, idle share). The probe (``diag.probe``) runs first
in the device phase. The line before
the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import re
import shutil
import socket
import statistics
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nerve_tpu_torch import ops
from nerve_tpu_torch.diag import _common
from nerve_tpu_torch.diag import continual as diag_continual
from nerve_tpu_torch.diag import correlation as diag_corr
from nerve_tpu_torch.diag import d2s as diag_d2s
from nerve_tpu_torch.diag import probe
from nerve_tpu_torch.diag import planar as diag_planar
from nerve_tpu_torch.diag.planar import launch_path
from nerve_tpu_torch.diag import rdb as diag_rdb
from nerve_tpu_torch.diag import federated as diag_fed
from nerve_tpu_torch.diag import recovery as diag_recovery
from nerve_tpu_torch.diag import train as diag_train
from nerve_tpu_torch.diag.conv import (
    BLOCKS,
    FEATURES,
    STEPS,
    H,
    W,
    bound,
    chain_bytes,
    chain_ops,
    conv_params,
    cudnn_chain,
    int8_layer_shapes,
    int_mm_yardstick,
    measure,
    nbytes,
    pixels,
    profile,
    rdb_int8_shapes,
    run_frames,
    run_stream,
    seeded_lightweight,
    seeded_model,
    serving_inputs,
    streamer,
)
from nerve_tpu_torch.diag.conv import seed_all
from nerve_tpu_torch.models import (
    EngineConfig,
    LightweightSuperResolution,
    SuperResolutionNet,
    api,
    flax_variables,
    import_torch,
    quantize_sr,
    streaming_prime,
    streaming_step,
    streaming_step_pair,
)
from nerve_tpu_torch import enhance, train_abr, training
from nerve_tpu_torch.abr import ABRConfig, PPOAgent
from nerve_tpu_torch.diag import abr as diag_abr
from nerve_tpu_torch.config.schema import TrainingConfig
from nerve_tpu_torch.utils import data as data_lib
from nerve_tpu_torch.utils.checkpoint import CheckpointManager
from nerve_tpu_torch.federated.privacy import PrivacyConfig
from nerve_tpu_torch.train_federated import client_dataset, stacked_client_data
from nerve_tpu_torch.ops import (
    _build,
    conv_chain,
    conv_chain_int8,
    correlation,
    dispatch,
    planar_chain,
    rdb,
    rdb_int8,
    rdb_taps,
)

d2s = importlib.import_module("nerve_tpu_torch.ops.pixel_shuffle")

# Slice limits on the [0, 1] bfloat16 output, kernels vs plain versions.
# Measured 3.9e-3 and 6.3e-5 on an H100 (one-ulp bf16 flips carried through
# 8 RDBs); a wrong tap, channel or edge moves outputs by O(0.1).
SLICE_MAX_ABS, SLICE_MEAN_ABS = 2e-2, 5e-4
# The same for the int8 slice: one int8 step of a requantised intermediate
# that flips between the two runs moves the output by less than this.
INT8_MAX_ABS, INT8_MEAN_ABS = 2e-2, 1e-3
INT8_MIN_PSNR = 30.0  # dB, int8 slice vs bf16 slice (tests/test_quantize.py)
# The lightweight slice, kernels vs plain versions. Measured 3.9e-3 and
# 2.5e-9 on an H100 (a few one-ulp bf16 flips in 25M outputs; the
# depthwise layers are bit-exact); limits ~5x and ~6x that.
LIGHT_MAX_ABS, LIGHT_MEAN_ABS = 2e-2, 1.5e-8
# Its body through the planar chain vs through the per-layer kernels,
# relative to max|per-layer|: the conv-chain level.
PLANAR_BODY_REL = 2.4e-2


def conv_chain_int8_plain_op(x, qchain, out_cout, out_dtype=None, packed=None):
    """``conv_chain_int8_plain`` under ``ops.conv_chain_int8_apply``'s signature."""
    qlayers, s_in, acts = qchain
    return conv_chain_int8.conv_chain_int8_plain(x, qlayers, s_in, acts, out_cout, out_dtype)


def rdb_chain_int8_plain_op(x, qchain, out_dtype=None, int32_taps=None, dx_major=None,
                            packed=None):
    """``rdb_chain_int8_plain`` under ``ops.rdb_chain_int8_apply``'s signature."""
    return rdb_int8.rdb_chain_int8_plain(x, qchain, out_dtype, int32_taps, dx_major)


KERNELS = {  # name -> (source, TPU kernel it replaces, plain version)
    "d2s_packed": ("nerve_tpu_torch/csrc/d2s_packed.cu",
                   "nerve_tpu/ops/pixel_shuffle.py:95", d2s.depth_to_space_packed_plain),
    "correlation": ("nerve_tpu_torch/csrc/correlation.cu",
                    "nerve_tpu/ops/correlation.py:52", correlation.correlation_plain),
    "conv_chain": ("nerve_tpu_torch/csrc/conv_chain.cu",
                   "nerve_tpu/ops/conv_chain.py:169", conv_chain.conv_chain_plain),
    "conv_chain_dw3": ("nerve_tpu_torch/csrc/dwconv3.cu",
                       "nerve_tpu/ops/conv_chain.py:169", conv_chain.conv_chain_plain),
    "planar_chain": ("nerve_tpu_torch/csrc/planar_chain.cu",
                     "nerve_tpu/ops/planar_chain.py:107", planar_chain.planar_chain_plain),
    "rdb": ("nerve_tpu_torch/csrc/rdb.cu", "nerve_tpu/ops/rdb.py:121", rdb.rdb_chain_plain),
    "conv_chain_int8": ("nerve_tpu_torch/csrc/conv_int8.cu",
                        "nerve_tpu/ops/conv_chain_int8.py:135", conv_chain_int8_plain_op),
    "rdb_int8": ("nerve_tpu_torch/csrc/rdb_int8.cu", "nerve_tpu/ops/rdb_int8.py:245",
                 rdb_chain_int8_plain_op),
    # The float32 route's dense layer and fusion: one implicit-GEMM family
    # (phases 10 and 11 time them; the meta step carries them).
    "conv_f32": ("nerve_tpu_torch/csrc/conv_f32.cuh", "nerve_tpu/ops/conv_chain.py:169",
                 conv_chain.conv_chain_plain),
    "rdb_lff_f32": ("nerve_tpu_torch/csrc/conv_f32.cuh", "nerve_tpu/ops/rdb.py:121",
                    rdb.lff_plain),
    # The RDB fusions alone (each also runs inside its RDB above).
    "rdb_lff": ("nerve_tpu_torch/csrc/rdb.cu", "nerve_tpu/ops/rdb.py:121", rdb.lff_plain),
    "rdb_lff_i8": ("nerve_tpu_torch/csrc/rdb_int8.cu", "nerve_tpu/ops/rdb_int8.py:245",
                   rdb_int8.lff_plain_i8),
    # The int8 paths' input quantisation: an XLA fusion in the JAX package.
    "quantize_i8": ("nerve_tpu_torch/csrc/quantize_i8.cu", "nerve_tpu/ops/conv_chain_int8.py:284",
                    conv_chain_int8.quantize_into_plain),
    # The diagnostic paths' kernels (phase 6).
    "rdb_int8_int32_taps": ("nerve_tpu_torch/csrc/conv_int8.cu",
                            "nerve_tpu/ops/rdb_int8.py:245", rdb_int8.rdb_chain_int8_plain),
    "rdb_taps": ("nerve_tpu_torch/csrc/rdb_taps.cu", "scripts/diag_rdb.py:406",
                 rdb_taps.rdb_taps_plain),
    "d2s_packed_planar": ("nerve_tpu_torch/csrc/d2s_packed.cu", "scripts/diag_d2s.py:140",
                          d2s.depth_to_space_packed_planar_plain),
    "probe": ("nerve_tpu_torch/csrc/probe.cu", "scripts/tpu_probe.py:37",
              probe.probe_scale2_plain),
}
# bf16 kernels: limits (float32, bfloat16) relative to max|plain|.
BF16_LIMITS = {"d2s_packed": (0.0, 0.0), "correlation": (1e-5, 1e-2),
               "conv_chain": (1e-4, 2.4e-2), "conv_chain_dw3": (1e-4, 2.4e-2),
               "planar_chain": (1e-4, 2.4e-2), "planar_chain pack in the call": (1e-4, 2.4e-2),
               "rdb": (1e-4, 1.56e-2),
               "rdb_lff": (1e-4, 1.56e-2)}
CHAIN_KERNELS = ("conv_chain", "conv_chain_dw3", "planar_chain", "planar_chain pack in the call")
# The ops the model calls, and the plain version each is replaced by in
# the reference runs.
OPS_OF = {"d2s_packed": "depth_to_space_packed", "correlation": "correlation_volume",
          "conv_chain": "conv_chain_apply", "conv_chain_dw3": "conv_chain_apply",
          "planar_chain": "planar_chain_apply", "rdb": "rdb_chain_apply",
          "conv_chain_int8": "conv_chain_int8_apply", "rdb_int8": "rdb_chain_int8_apply"}


@contextlib.contextmanager
def plain_ops():
    """Route the models' kernel ops to their plain versions."""
    saved = {op: getattr(ops, op) for op in OPS_OF.values()}
    for name, op in OPS_OF.items():
        setattr(ops, op, KERNELS[name][2])
    try:
        yield
    finally:
        for op, fn in saved.items():
            setattr(ops, op, fn)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


PROBE_REPS = 25


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``fn`` on the card (CUDA events), after a warm-up."""
    return _common.median_ms(fn, torch.device("cuda"), reps)


def _randn(g, shape, std=1.0):
    return torch.randn(shape, generator=g) * std


# --------------------------------------------------------------------------- #
# Work counts: the bound is max(ops / peak, bytes / memory rate)
# --------------------------------------------------------------------------- #
def rdb_ops(plist, npix: int) -> int:
    return sum(2 * math.prod(p.shape) * npix
               for params in plist for p in params if p.ndim > 1)


# Dense-convolution and RDB-fusion kernels -> (their warpgroup product, the
# mma.sync product they must not issue), as cuobjdump -sass names them.
SASS_PRODUCTS = {"conv_wgmma_kernel": ("HGMMA", "HMMA"),
                 "conv_i8_wgmma_kernel": ("IGMMA", "IMMA"),
                 "lff_wgmma_kernel": ("HGMMA", "HMMA"),
                 "lff_i8_wgmma_kernel": ("IGMMA", "IMMA"),
                 "taps_wgmma_kernel": ("HGMMA", "HMMA")}


def check_sass(lib: Path) -> None:
    """The dense-convolution kernels (``conv_wgmma_kernel<K, N>``, bf16;
    ``conv_i8_wgmma_kernel<K, N, MODE>``, int8), the RDB fusions
    (``lff_wgmma_kernel``, ``lff_i8_wgmma_kernel``) and the bf16 RDB layer
    under the TPU rounding contracts (``taps_wgmma_kernel<N, FAMILY>``)
    must each be in the library and issue warpgroup products and no
    ``mma.sync`` products (``SASS_PRODUCTS``): print each instance's counts
    and its ptxas registers and spills."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name, kernel = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernel = next((k for k in SASS_PRODUCTS if re.search(rf"\d{k}[IE]", name)), None)
        elif kernel:
            gmma, mma = SASS_PRODUCTS[kernel]
            c = counts.setdefault(name, [kernel, 0, 0])
            c[1] += re.search(rf"\b{gmma}\b", line) is not None
            c[2] += re.search(rf"\b{mma}\b", line) is not None
    log = lib.with_suffix(".log").read_text().splitlines()
    for name, (kernel, gmma, mma) in sorted(counts.items()):
        args = ", ".join(re.findall(r"Li(\d+)E", name))
        usage = dict.fromkeys(u.split(":", 1)[-1].strip() for i, line in enumerate(log)
                              if "Compiling entry function" in line and name in line
                              for u in log[i + 1:i + 5] if "spill" in u or "Used" in u)
        label = f"{kernel}<{args}>" if args else kernel
        print(f"sass {label}: {gmma} {SASS_PRODUCTS[kernel][0]}, {mma} "
              f"{SASS_PRODUCTS[kernel][1]}; {'; '.join(usage)}", flush=True)
    found = {kernel for kernel, *_ in counts.values()}
    if found != set(SASS_PRODUCTS) or any(gmma == 0 or mma for _k, gmma, mma in counts.values()):
        raise AssertionError(f"the dense conv kernels do not run on warpgroup products alone: "
                             f"{counts}")


# --------------------------------------------------------------------------- #
# Library yardsticks: one PyTorch call (or one per layer) for the same function
# --------------------------------------------------------------------------- #
def library_d2s(x):
    b, h, w, c = x.shape
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).reshape(
        b, 2 * h, 2 * w * (c // 4))


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
def bf16_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, work) at small or serving shapes."""
    g = torch.Generator().manual_seed(7)
    gd = torch.Generator(device=dev).manual_seed(7)  # the activations, drawn on the card

    def act(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(dt)

    if serving:
        x = torch.rand((1, H, W, 12), generator=g).to(dev, dt)
        f1, f2 = act(2, H // 2, W // 2, FEATURES), act(2, H // 2, W // 2, FEATURES)
        sites = serving_inputs(g, dev, dt)
        xr = act(1, H, W, FEATURES)
        plist = [_common.rdb_params(g, FEATURES, dev, dt) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        x = act(2, 13, 37, 12)
        f1, f2 = act(2, 11, 35, 16), act(2, 11, 35, 16)
        sites = [([act(2, 9, 35, 4) for _ in range(3)], conv_params(g, [12, 40, 20, 3, 12], dev))]
        xr = act(1, 10, 33, 16)
        plist = [_common.rdb_params(g, 16, dev, dt) for _ in range(2)]
        label = "small ragged"

    # The seeded lightweight body: its four depthwise layers, each on a
    # 32-channel activation, and the whole chain on a planar frame.
    body = [(w.detach(), b.detach(), a) for w, b, a in seeded_lightweight(dev, 3).chain()]
    dws = [e for e in body if e[0].ndim == 3]
    shape = (1, H, W) if serving else (2, 13, 37)
    dw_in = [torch.rand((*shape, 32), generator=g).to(dev, dt) for _ in dws]
    xp = torch.rand((shape[0], 3, *shape[1:]), generator=g).to(dev, dt)
    lw_label = "lightweight body 1080p" if serving else label
    dw_libs = [cudnn_chain([e], dt) for e in dws]
    planar_lib = cudnn_chain(body, dt)
    planar_pack = planar_chain.packed_planar_chain(body, dt, dev)

    def chains(fn):
        return lambda: [fn(xx, p) for xx, p in sites]

    def dw_layers(fn):
        return lambda: [fn(a, [e]) for a, e in zip(dw_in, dws)]

    libs = [(xx, cudnn_chain(p, dt)) for xx, p in sites]
    # The fusion alone: the leading C + L·G channels of the buffer in; at
    # the small shape from a wider buffer into an offset slot.
    lc, lcat, lpad, lcoff = (FEATURES, FEATURES + 160, 0, 0) if serving else (16, 176, 8, 8)
    cat = act(*xr.shape[:3], lcat + lpad) if serving else act(2, 13, 37, lcat + lpad)
    lw = _randn(g, (lcat, lc), lcat ** -0.5).to(dev, dt)
    lb = _randn(g, (lc,), 0.1).to(dev)
    lout = torch.zeros((*cat.shape[:3], lc + lcoff), dtype=dt, device=dev)
    lflat = cat.view(-1, lcat) if serving else None
    corr_ops = 2 * 81 * f1.shape[-1] * pixels(f1)
    out_corr = math.prod(f1.shape[:3]) * 81 * f1.element_size()
    site_bytes = sum(chain_bytes(xx, p, dt) for xx, p in sites)
    planar_work = bound(chain_ops(body, xp[0, 0].numel() * xp.shape[0]),
                        nbytes(xp) * 5 + nbytes(*(t for w, b, _ in body for t in (w, b))), "bf16")
    return {
        "d2s_packed": (label, lambda: ops.depth_to_space_packed(x, 2),
                       lambda: d2s.depth_to_space_packed_plain(x, 2),
                       lambda: library_d2s(x), bound(0, 2 * nbytes(x), "bf16")),
        "correlation": (label, lambda: ops.correlation_volume(f1, f2, 4),
                        lambda: correlation.correlation_plain(f1, f2, 4), None,
                        bound(corr_ops, nbytes(f1, f2) + out_corr, "bf16")),
        "conv_chain": (label, chains(ops.conv_chain_apply), chains(conv_chain.conv_chain_plain),
                       lambda: [fn(xx) for xx, fn in libs],
                       bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), site_bytes,
                             "bf16")),
        "conv_chain_dw3": (lw_label, dw_layers(ops.conv_chain_apply),
                           dw_layers(conv_chain.conv_chain_plain),
                           lambda: [fn(a) for a, fn in zip(dw_in, dw_libs)],
                           bound(sum(chain_ops([e], pixels(a)) for a, e in zip(dw_in, dws)),
                                 sum(2 * nbytes(a) + nbytes(*e[:2]) for a, e in zip(dw_in, dws)),
                                 "bf16")),
        "planar_chain": (lw_label, lambda: ops.planar_chain_apply(xp, body, packed=planar_pack),
                         lambda: planar_chain.planar_chain_plain(xp, body),
                         lambda: planar_lib(xp.permute(0, 2, 3, 1)), planar_work),
        "planar_chain pack in the call": (lw_label, lambda: ops.planar_chain_apply(xp, body),
                                          lambda: planar_chain.planar_chain_plain(xp, body),
                                          None, planar_work),
        "rdb": (label, lambda: ops.rdb_chain_apply(xr, plist),
                lambda: rdb.rdb_chain_plain(xr, plist), None,
                bound(rdb_ops(plist, pixels(xr)), 2 * nbytes(xr) + nbytes(*sum(plist, [])),
                      "bf16")),
        "rdb_lff": (f"{label}: fusion {lcat}->{lc}",
                    lambda: rdb.lff_launch(cat, lw, lb, lout, lcoff)[..., lcoff:],
                    lambda: rdb.lff_plain(cat, lw, lb),
                    (lambda: torch.matmul(lflat, lw)) if serving else None,
                    bound(2 * lcat * lc * pixels(cat),
                          pixels(cat) * (lcat + lc) * dt.itemsize + nbytes(lw, lb), "bf16")),
    }


def int8_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, limit, work, library call):
    each chain and the RDB stack calibrated on its own input, every case
    bit-exact (limit 0); at the small shapes also the RDB in its three tap
    schedules over many tiles per block at a ragged shape (cin not a
    multiple of the 32-channel chunk), and the input quantisation on ties
    and values past ±127."""
    g = torch.Generator().manual_seed(8)
    if serving:
        sites = serving_inputs(g, dev, dt)
        xr = (torch.randn((1, H, W, FEATURES), generator=torch.Generator(device=dev).manual_seed(8),
                          device=dev) * 0.5).to(dt)
        plist = [_common.rdb_params(g, FEATURES, dev, torch.float32) for _ in range(BLOCKS)]
        label = f"serving 1080p ({BLOCKS} RDBs, 5 chain sites)"
    else:
        sites = [([_randn(g, (2, 9, 35, 4)).to(dev, dt) for _ in range(3)],
                  conv_params(g, [12, 40, 20, 3, 12], dev, kinds=[3, 1, 3, 3])),
                 (_randn(g, (1, 13, 37, 3)).to(dev, dt), conv_params(g, [3, 24], dev, ["relu"]))]
        xr = _randn(g, (1, 10, 33, 16), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, 16, dev, torch.float32) for _ in range(2)]
        label = "small ragged"
    qsites, chain_bytes = [], 0
    for xx, p in sites:
        scales = conv_chain_int8.calibrate_conv_chain(xx, p)
        qchain = conv_chain_int8.quantize_conv_chain(p, scales)
        cout = p[-1][0].shape[-1]
        qsites.append((xx, qchain, cout, conv_chain_int8.packed_chain(qchain[0], cout)))
        chain_bytes += (nbytes(*(xx if isinstance(xx, list) else [xx]),
                               *(t for layer in qchain[0] for t in layer))
                        + pixels(xx) * cout * dt.itemsize)
    rscales = rdb_int8.calibrate_rdb_chain(xr, plist)
    qrdb = rdb_int8.quantize_rdb_chain(plist, rscales)
    prdb = rdb_int8.packed_rdb_chain(qrdb)
    rdb_bytes = 2 * nbytes(xr) + nbytes(*(t for wq, dq, meta in qrdb for t in (*wq, dq, meta)))

    def chains(fn):
        return lambda: [fn(xx, q, cout, dt, packed=pk) for xx, q, cout, pk in qsites]

    # The attention site's three 64-channel frames (the serving shape), or
    # ragged parts holding values at and next to (k + 0.5)·s, some of which
    # round otherwise under x · (1 / s) than under x / s, and values past
    # ±127·s.
    s_q = torch.tensor(0.3 if not serving else 0.05, device=dev)
    if serving:
        qparts = sites[2][0]
    else:
        qparts = []
        for c in (3, 16, 9):
            v = _randn(g, (2, 7, 11, c), 60.0)
            ties = (torch.randint(-140, 140, v.shape, generator=g) + 0.5) * 0.3
            r = torch.rand(v.shape, generator=g)
            ties = torch.where(r < 0.2, ties, torch.nextafter(ties, torch.where(
                r < 0.35, torch.tensor(float("inf")), torch.tensor(float("-inf")))))
            qparts.append(torch.where(r < 0.5, ties, v).to(dev, dt))
    # The int8 fusion alone, into the next block's int8 buffer (at the small
    # shape a wider one, at an offset): in channels [0, C / 2) the factors
    # and biases are 0 and s_in = s_next / 2, so v = x · s_in sits on .5
    # steps of s_next.
    fc, fcat = (FEATURES, FEATURES + 160) if serving else (16, 176)
    fshape = (1, H, W) if serving else (2, 13, 37)
    fpad, fcoff = (0, 0) if serving else (16, 16)
    fx = torch.randint(-127, 128, (*fshape, fcat + fpad), generator=g, dtype=torch.int8).to(dev)
    fw = torch.randint(-127, 128, (fcat, fc), generator=g, dtype=torch.int8)
    fimage = conv_chain_int8.pack_i8_weights(fw, 1, fc, fc, rdb_int8.LFF_N_TILE).to(dev)
    fdq, fbias = torch.rand(fc, generator=g) * 1e-4, _randn(g, (fc,), 0.1)
    fdq[:fc // 2], fbias[:fc // 2] = 0.0, 0.0
    fdq, fbias, fw = fdq.to(dev), fbias.to(dev), fw.to(dev)
    fs_next = torch.tensor([0.3], device=dev)
    fs_in = fs_next / 2
    fout = torch.zeros((*fshape, fcat + fpad), dtype=torch.int8, device=dev)
    fnpix = math.prod(fshape)
    qc = sum(t.shape[-1] for t in qparts)
    qbufs = [torch.empty((*qparts[0].shape[:3], -(-qc // 16) * 16), dtype=torch.int8,
                         device=dev) for _ in range(2)]
    cases = {
        "conv_chain_int8": (label, chains(ops.conv_chain_int8_apply),
                            chains(conv_chain_int8_plain_op), 0.0,
                            bound(sum(chain_ops(p, pixels(xx)) for xx, p in sites), chain_bytes,
                                  "int8"),
                            int_mm_yardstick([s for xx, p in sites
                                              for s in int8_layer_shapes(xx, p)], dev)),
        "rdb_int8": (label, lambda: ops.rdb_chain_int8_apply(xr, qrdb, packed=prdb),
                     lambda: rdb_int8.rdb_chain_int8_plain(xr, qrdb), 0.0,
                     bound(rdb_ops(plist, pixels(xr)), rdb_bytes, "int8"),
                     int_mm_yardstick(rdb_int8_shapes(pixels(xr), xr.shape[-1]), dev,
                                      repeat=len(plist))),
        # Each block alone with float32 output.
        "rdb_int8 block f32": (label, lambda: [ops.rdb_chain_int8_apply(
            xr.float(), (blk,), out_dtype=torch.float32, packed=prdb[k:k + 1])
            for k, blk in enumerate(qrdb[:2])],
            lambda: [rdb_int8.rdb_chain_int8_plain(xr.float(), (blk,), torch.float32)
                     for blk in qrdb[:2]], 0.0, None, None),
        "rdb_lff_i8": (f"{label}: fusion {fcat}->{fc}, int8 out",
                       lambda: (rdb_int8.lff_launch_i8(fx, fcat, fimage, fdq, fbias, fs_in,
                                                       fs_next, fout, fcoff),
                                fout[..., fcoff:fcoff + fc])[1],
                       lambda: rdb_int8.lff_plain_i8(fx, fw, fdq, fbias, fs_in[0], fs_next[0]),
                       0.0,
                       bound(2 * fcat * fc * fnpix, fnpix * (fcat + fc) + fimage.numel(), "int8"),
                       int_mm_yardstick([(1, fcat, fc, fnpix)], dev)),
        "quantize_i8": (f"{label}: {len(qparts)} parts, {qc} channels",
                        lambda: conv_chain_int8.quantize_into(qparts, s_q, qbufs[0],
                                                              qbufs[0].shape[-1]),
                        lambda: conv_chain_int8.quantize_into_plain(qparts, s_q, qbufs[1],
                                                                    qbufs[1].shape[-1]),
                        0.0, bound(0, nbytes(*qparts) + qbufs[0].numel(), "int8"), None),
    }
    if not serving:
        # Many tiles per block (the ping-pong rings turn over many times) at
        # ragged H, W and cin = 40 + 32 i, in each tap schedule.
        xm = _randn(g, (2, 131, 517, 40), 0.5).to(dev, dt)
        pm = [_common.rdb_params(g, 40, dev, torch.float32) for _ in range(2)]
        sm = rdb_int8.calibrate_rdb_chain(xm.float(), pm)
        for scheme, it, dx in (("per_column", False, False), ("per_column_dx", False, True),
                               ("int32_taps", True, False)):
            q = rdb_int8.quantize_rdb_chain(pm, sm, per_channel=it)
            pq = rdb_int8.packed_rdb_chain(q, it)
            cases[f"rdb_int8 many tiles {scheme}"] = (
                "ragged 2x131x517x40", lambda q=q, it=it, dx=dx, pq=pq: ops.rdb_chain_int8_apply(
                    xm, q, None, it, dx, pq),
                lambda q=q, it=it, dx=dx: rdb_int8.rdb_chain_int8_plain(xm, q, None, it, dx),
                0.0, None, None)
    return cases


def _as_list(y):
    return y if isinstance(y, list) else [y]


def compare(name, label, dt, kern, plain, limit, rel_scale=None, reps=5):
    """Kernel vs plain on the card: (max|err|, elements that differ, ms, plain ms),
    each time the median of ``reps`` calls."""
    got, ref = _as_list(kern()), _as_list(plain())
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    ndiff = sum(int((a != b).sum()) for a, b in zip(got, ref))
    if rel_scale is not None:
        limit *= max(max(b.float().abs().max().item() for b in ref), rel_scale)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, ref)) and (
        err == 0.0 if limit == 0.0 else err <= limit)
    del got, ref
    ms, pms = median_ms(kern, reps), median_ms(plain, reps)
    print(f"kernel {name:24s} {label:38s} {str(dt):15s} max|err| {err:.3e} (limit {limit:.3e}) "
          f"differ {ndiff} kernel {ms:.3f} ms plain {pms:.3f} ms {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"({label}, {dt}): max|err| {err}")
    torch.cuda.empty_cache()
    return err, ndiff, ms, pms


def check_kernels(dev) -> dict:
    """Kernel vs plain on the card; returns the serving-shape numbers per kernel."""
    summary = {}
    for serving in (False, True):
        for dt in (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lib, work) in bf16_kernel_cases(dev, dt, serving).items():
                lim = BF16_LIMITS[name][dt == torch.bfloat16]
                rel = 1.0 if name in CHAIN_KERNELS else 0.0
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim, rel)
                if serving and dt == torch.bfloat16:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib) if lib else None}
        # The int8 kernels take the model's bf16 activations at the serving shapes.
        for dt in (torch.bfloat16,) if serving else (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lim, work, lib) in int8_kernel_cases(
                    dev, dt, serving).items():
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim)
                if serving and work is not None:
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib) if lib else None}
                    torch.cuda.empty_cache()
    check_correlation_exact(dev, summary["correlation"]["ms"])
    for name, s in summary.items():
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.3f} ms"
        if name.startswith(("conv_chain_int8", "rdb_int8")) and s["library_ms"] is not None:
            lib += " (torch._int_mm, products only)"
        print(f"bound {name:16s} {s['bound_ms']:.3f} ms ({s['bound_by']}), kernel "
              f"{s['ms']:.3f} ms: {s['bound_ms'] / s['ms']:.3f} of the bound; library {lib}",
              flush=True)
    return summary


def print_launch_records(dev) -> None:
    """The launches of the depthwise layer (the serving shape, and 128
    channels in two slices), the d2s kernels (NHWC and planar at the
    serving shape, planar at odd widths with s = 3, 4) and the bf16
    ``rdb_taps`` layer under each contract (the widest layer of a 1080p ×
    64 block, cin 192, and cin 384 at growth 64): route or plan, grid,
    threads, shared memory, registers, spills."""
    for c in (32, 128):
        x = torch.zeros((1, H, W, c), dtype=torch.bfloat16, device=dev)
        print(f"launch conv_chain_dw3 (1, {H}, {W}, {c}) bf16: "
              f"{json.dumps(conv_chain.dwconv3_launch_record(x))}", flush=True)
    x = torch.zeros((1, H, W, 12), dtype=torch.bfloat16, device=dev)
    print(f"launch d2s_packed (1, {H}, {W}, 12) bf16 s=2: {json.dumps(d2s.launch_record(x, 2))}",
          flush=True)
    for shape, s in (((1, 12, H, W), 2), ((1, 27, 9, 41), 3), ((2, 32, 7, 33), 4)):
        x = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        print(f"launch d2s_packed_planar {shape} bf16 s={s}: "
              f"{json.dumps(d2s.planar_launch_record(x, s))}", flush=True)
    for cin, cout, k, lff in ((3, 32, 3, False), (FEATURES, FEATURES, 3, False),
                              (32, 12, 3, False), (FEATURES + 128, 32, 3, False),
                              (FEATURES + 160, FEATURES, 1, True)):
        x = torch.zeros((1, H, W, -(-cin // 8) * 8 if cin > 3 else 3), device=dev)
        print(f"launch {'rdb_lff_f32' if lff else 'conv_f32'} (1, {H}, {W}) cin {cin} -> {cout} "
              f"{k}x{k} float32: {json.dumps(conv_chain.f32_launch_record(x, cin, cout, k, lff))}",
              flush=True)
    del x
    x = torch.zeros((1, H, W, FEATURES), dtype=torch.bfloat16, device=dev)
    for mode in rdb_taps.CONTRACTS:
        for cin, cout in ((FEATURES + 128, 32), (384, 64)):
            print(f"launch rdb_taps {mode} (1, {H}, {W}) cin {cin} -> {cout} bf16: "
                  f"{json.dumps(rdb_taps.launch_record(x, cin, cout, mode))}", flush=True)


def check_wide_depthwise(dev) -> None:
    """The depthwise layer wider than one 64-channel slice, C = 96, 128 and
    200, on both routes ("tile": an input 2 elements into its storage) and
    in both dtypes, against its plain version at the conv chain's limits."""
    g = torch.Generator().manual_seed(12)
    for c in (96, 128, 200):
        for dt in (torch.float32, torch.bfloat16):
            for route, off in (("tma", 0), ("tile", 2)):
                shape = (1, 270, 480, c)
                x = _randn(g, (math.prod(shape) + off,)).to(dev, dt)[off:].view(shape)
                layer = [((_randn(g, (3, 3, c)) / 3).to(dev), _randn(g, (c,), 0.1).to(dev),
                          "relu")]
                rec = conv_chain.dwconv3_launch_record(x)
                if rec["route"] != route:
                    raise AssertionError(f"dw3 C={c} {dt}: route {rec['route']}, not {route}")
                compare(f"conv_chain_dw3 C={c} {route}", f"{shape}, {rec['slices']} slices", dt,
                        lambda x=x, layer=layer: ops.conv_chain_apply(x, layer),
                        lambda x=x, layer=layer: conv_chain.conv_chain_plain(x, layer),
                        BF16_LIMITS["conv_chain_dw3"][dt == torch.bfloat16], 1.0)


def check_planar_non_finite(dev) -> None:
    """The lightweight body through the planar chain on planar frames holding
    one +Inf, one -Inf and one NaN: its output must be not finite exactly
    where the plain version's is (the plain version on the CPU, whose
    convolutions are direct), and its finite values within the chain's
    limit."""
    g = torch.Generator().manual_seed(13)
    body = [(w.detach(), b.detach(), a) for w, b, a in seeded_lightweight(dev, 3).chain()]
    cpu_body = [(w.cpu(), b.cpu(), a) for w, b, a in body]
    for dt in (torch.float32, torch.bfloat16):
        x = torch.rand((2, 3, 67, 131), generator=g)
        x[0, 0, 5, 7], x[0, 1, 40, 60], x[1, 2, 30, 128] = (float("inf"), float("-inf"),
                                                            float("nan"))
        got = ops.planar_chain_apply(x.to(dev, dt), body)
        ref = planar_chain.planar_chain_plain(x.to(dt), cpu_body).to(dev)
        bad = ~torch.isfinite(ref)
        same = torch.equal(~torch.isfinite(got), bad)
        scale = ref.float().masked_fill(bad, 0).abs().max().item()
        err = (got.float() - ref.float()).masked_fill(bad, 0).abs().max().item()
        lim = BF16_LIMITS["planar_chain"][dt == torch.bfloat16] * scale
        ok = same and 0 < int(bad.sum()) and err <= lim
        print(f"kernel {'planar_chain non-finite':24s} {'lightweight body 2x67x131':38s} "
              f"{str(dt):15s} not finite {int(bad.sum())} (mask {'equal' if same else 'DIFFERS'}), "
              f"finite max|err| {err:.3e} (limit {lim:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the planar chain's non-finite values or finite values differ "
                                 "from its plain version's")
    # A finite input whose second layer's sums overflow bf16 inside the chain.
    for c in (32, 20):
        x, params = diag_planar.overflow_case(c, dev)
        got = ops.planar_chain_apply(x, params)
        ref = planar_chain.planar_chain_plain(
            x.cpu(), [(w.cpu(), b.cpu(), a) for w, b, a in params]).to(dev)
        bad = ~torch.isfinite(ref)
        same = all(torch.equal(f(got), f(ref))
                   for f in (torch.isnan, torch.isposinf, torch.isneginf))
        scale = ref.float().masked_fill(bad, 0).abs().max().item()
        err = (got.float() - ref.float()).masked_fill(bad, 0).abs().max().item()
        lim = BF16_LIMITS["planar_chain"][1] * scale
        ok = same and 0 < int(bad.sum()) and err <= lim and bool(torch.isfinite(x).all())
        print(f"kernel {'planar_chain overflow':24s} {f'width {c}, finite input 2x37x101':38s} "
              f"{'torch.bfloat16':15s} +Inf {int(torch.isposinf(ref).sum())}, NaN in the "
              f"kernel's {int(torch.isnan(got).sum())} (masks {'equal' if same else 'DIFFER'}), "
              f"finite max|err| {err:.3e} (limit {lim:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the planar chain's values after an overflow inside the chain "
                                 "differ from its plain version's")


def check_correlation_exact(dev, ms: float) -> None:
    """The correlation on the exact-sum input at the serving shape: bit-exact
    against its plain version, each value inside the frame 2⁻¹⁸ / C; then the
    serving-shape time ``ms`` beside the byte bound and the two bounds of the
    kernel's CUDA-core design."""
    f1, f2, inside = diag_corr.exact_sum_inputs(2, H // 2, W // 2, FEATURES, device=dev)
    got = ops.correlation_volume(f1, f2, 4)
    ref = correlation.correlation_plain(f1, f2, 4)
    ok = torch.equal(got, ref) and bool(got[:, 4:-4, 4:-4].float().eq(inside).all())
    print(f"kernel {'correlation exact sum':24s} {'serving 2x540x960x64':38s} "
          f"{'torch.bfloat16':15s} {'bit-exact' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the correlation kernel differs from its plain version on the "
                             "exact-sum input: a product not rounded to bfloat16")
    del f1, f2, got, ref
    b = diag_corr.bounds_ms((2, H // 2, W // 2, FEATURES), 4, 2)
    print(f"bound correlation bytes {b['bytes']:.4f} ms; this design's: float32 peak "
          f"{b['float32_peak']:.4f} ms, issue (2.5 instructions a product) {b['issue']:.4f} ms; "
          f"kernel {ms:.4f} ms: {b['issue'] / ms:.3f} of the issue bound", flush=True)
    torch.cuda.empty_cache()


def diag_kernel_cases(dev, dt, serving: bool):
    """name -> (label, kernel call, plain call, limit, relative, library call,
    work, margin) of the diagnostic paths' kernels. ``limit`` is relative to
    max|plain| where ``relative``, else absolute; ``margin``, for the bf16
    RDB contracts, returns ``rdb_taps.contract_margin`` of the kernel's
    output."""
    g = torch.Generator().manual_seed(9)
    if serving:
        xr = _randn(g, (1, H, W, FEATURES), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, FEATURES, dev, torch.float32) for _ in range(BLOCKS)]
        xb = _randn(g, (1, H, W, FEATURES)).to(dev, dt)
        block = _common.rdb_params(g, FEATURES, dev, dt)
        xp = torch.rand((1, 12, H, W), generator=g).to(dev, dt)
        modes = (*rdb_taps.CONTRACTS, "noshift", "nolff")
        label = f"serving 1080p ({BLOCKS} int8 RDBs, 1 RDB)"
    else:
        xr = _randn(g, (1, 10, 33, 16), 0.5).to(dev, dt)
        plist = [_common.rdb_params(g, 16, dev, torch.float32) for _ in range(2)]
        xb = _randn(g, (2, 13, 37, 12)).to(dev, dt)
        block = _common.rdb_params(g, 12, dev, dt)
        xp = torch.rand((2, 12, 13, 37), generator=g).to(dev, dt)
        modes = (*rdb_taps.CONTRACTS, "noshift", "nolff")
        label = "small ragged"
    rscales = rdb_int8.calibrate_rdb_chain(xr, plist)
    qpc = rdb_int8.quantize_rdb_chain(plist, rscales, per_channel=True)
    qcol = rdb_int8.quantize_rdb_chain(plist, rscales)
    rdb_bytes = 2 * nbytes(xr) + nbytes(*(t for wq, dq, meta in qpc for t in (*wq, dq, meta)))
    int8_work = bound(rdb_ops(plist, pixels(xr)), rdb_bytes, "int8")
    cases = {}
    # Both schedules are bit-exact: the same int32 sums, the same float32
    # operations in the same order.
    # The per-column schedule's products, as torch._int_mm computes them.
    int_mm = int_mm_yardstick(rdb_int8_shapes(pixels(xr), xr.shape[-1]), dev, repeat=len(plist))
    for name, q, it, dx in (("rdb_int8_int32_taps", qpc, True, False),
                            ("rdb_int8 per_column_dx", qcol, False, True)):
        pq = rdb_int8.packed_rdb_chain(q, it)
        cases[name] = (label, lambda q=q, it=it, dx=dx, pq=pq: ops.rdb_chain_int8_apply(
                           xr, q, None, it, dx, pq),
                       lambda q=q, it=it, dx=dx: rdb_int8.rdb_chain_int8_plain(xr, q, None, it, dx),
                       0.0, False, int_mm, int8_work, None)
    taps_work = bound(rdb_ops([block], pixels(xb)), 2 * nbytes(xb) + nbytes(*block), "bf16")
    lim = BF16_LIMITS["rdb"][dt == torch.bfloat16]
    for mode in modes:
        name = "rdb_taps" if mode == "pallas_dx" else f"rdb_taps {mode}"
        margin = (lambda m=mode: rdb_taps.contract_margin(ops.rdb_taps_apply(xb, block, m),
                                                          xb, block, m)
                  ) if dt == torch.bfloat16 and mode in rdb_taps.CONTRACTS else None
        cases[name] = (label, lambda m=mode: ops.rdb_taps_apply(xb, block, m),
                       lambda m=mode: rdb_taps.rdb_taps_plain(xb, block, m), lim, True, None,
                       taps_work, margin)
    if not serving:
        # Many tiles per block at an odd shape, and a block of 128 features
        # and growth 64 whose widest layer reads 384 channels (two N tiles,
        # the weights streamed with each chunk).
        for tag, shape, c, growth in (("many tiles", (1, 131, 517), 64, 32),
                                      ("cin 384", (1, 37, 101), 128, 64)):
            xt = _randn(g, (*shape, c)).to(dev, dt)
            blk = _common.rdb_params(g, c, dev, dt, growth=growth)
            for mode in rdb_taps.CONTRACTS:
                margin = (lambda m=mode, xt=xt, blk=blk: rdb_taps.contract_margin(
                    ops.rdb_taps_apply(xt, blk, m), xt, blk, m)) if dt == torch.bfloat16 else None
                cases[f"rdb_taps {tag} {mode}"] = (
                    f"{'x'.join(map(str, shape))}x{c}, growth {growth}",
                    lambda m=mode, xt=xt, blk=blk: ops.rdb_taps_apply(xt, blk, m),
                    lambda m=mode, xt=xt, blk=blk: rdb_taps.rdb_taps_plain(xt, blk, m), lim,
                    True, None, None, margin)
        # Odd widths at s = 3 and 4 (element loads into the staged rows).
        for shape, s in (((1, 27, 9, 41), 3), ((2, 32, 7, 33), 4)):
            xo = torch.rand(shape, generator=g).to(dev, dt)
            cases[f"d2s_packed_planar s={s}"] = (
                f"{'x'.join(map(str, shape))}", lambda xo=xo, s=s: ops.depth_to_space_packed_planar(
                    xo, s), lambda xo=xo, s=s: d2s.depth_to_space_packed_planar_plain(xo, s),
                0.0, False, None, None, None)
    cases["d2s_packed_planar"] = (
        label, lambda: ops.depth_to_space_packed_planar(xp, 2),
        lambda: d2s.depth_to_space_packed_planar_plain(xp, 2), 0.0, False,
        lambda: diag_d2s.library_planar(xp), bound(0, 2 * nbytes(xp), "bf16"), None)
    if dt == torch.float32:
        a = torch.rand((8, 128), generator=g).to(dev)
        cases["probe"] = ("(8, 128)", lambda: probe.probe_scale2(a),
                          lambda: probe.probe_scale2_plain(a), 0.0, False, lambda: a * 2.0,
                          bound(0, 2 * nbytes(a), "bf16"), None)
        # 4099 values at an odd offset: the scalar path.
        v = torch.rand(4100, generator=g).to(dev)[1:]
        cases["probe odd view"] = ("(4099,) at offset 1", lambda: probe.probe_scale2(v),
                                   lambda: probe.probe_scale2_plain(v), 0.0, False, None,
                                   None, None)
    return cases


def check_diag_kernels(dev) -> dict:
    """Phase 6a: the diagnostic paths' kernels against their plain versions;
    the serving-shape numbers of the four entries of the kernels line."""
    summary = {}
    for serving in (False, True):
        for dt in (torch.bfloat16,) if serving else (torch.float32, torch.bfloat16):
            for name, (label, kern, plain, lim, rel, lib, work, margin) in diag_kernel_cases(
                    dev, dt, serving).items():
                # The probe's time is host work: more calls for a steadier median.
                reps = PROBE_REPS if name == "probe" else 5
                err, _n, ms, pms = compare(name, label, dt, kern, plain, lim,
                                           0.0 if rel else None, reps)
                if margin is not None:
                    mine, least_other = margin()
                    ok = mine <= 0.25 * least_other
                    print(f"contract {name:24s} {label:38s} mean|d| vs its plain {mine:.3e}, "
                          f"vs the nearest other contract {least_other:.3e} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise AssertionError(f"{name} is nearer another contract's plain "
                                             f"version than a quarter of its own ({label})")
                    torch.cuda.empty_cache()
                if name in KERNELS and (serving or name == "probe"):
                    summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                     "bound_ms": work[0], "bound_by": work[1],
                                     "library_ms": median_ms(lib, reps) if lib else None}
    # matonly computes no layer, so it has no plain version: it must launch.
    g = torch.Generator().manual_seed(10)
    block = _common.rdb_params(g, 16, dev, torch.bfloat16)
    n0 = dispatch.launches["rdb_taps"]
    ops.rdb_taps_apply(_randn(g, (1, 10, 33, 16)).to(dev, torch.bfloat16), block, "matonly")
    torch.cuda.synchronize()
    if dispatch.launches["rdb_taps"] != n0 + 1:
        raise AssertionError("rdb_taps matonly did not launch")
    print("kernel rdb_taps matonly launched (no plain version: timing only)", flush=True)
    return summary


# --------------------------------------------------------------------------- #
# The slices
# --------------------------------------------------------------------------- #
def check_outputs(outs):
    for out in outs:
        if tuple(out.shape) != (1, 2 * H, 2 * W * 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()) or out.min() < 0 or out.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")


def drive(model, video, launched, idle, run=run_stream):
    """The main path with every count set to 0 just before and read just
    after; ``launched`` kernels must have run, ``idle`` ones must not."""
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    outs, times = run(model, video)
    launches = dict(dispatch.launches)
    print(f"slice launches {launches}", flush=True)
    missing = [k for k in launched if launches[k] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if any(launches[k] for k in idle):
        raise AssertionError(f"the main path launched {[k for k in idle if launches[k]]}")
    check_outputs(outs)
    return outs, times, launches, torch.cuda.max_memory_allocated() / 2**30


def against_plain(model, video, outs, max_abs, mean_abs, run=run_stream):
    dispatch.reset_launches()
    with plain_ops():
        ref, ptimes = run(model, video)
    if any(dispatch.launches.values()):
        raise AssertionError(f"the plain run launched kernels: {dispatch.launches}")
    dmax = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, ref))
    dmean = max((a.float() - b.float()).abs().mean().item() for a, b in zip(outs, ref))
    print(f"slice kernels vs plain: max|d| {dmax:.3e} (limit {max_abs}), "
          f"mean|d| {dmean:.3e} (limit {mean_abs})", flush=True)
    if dmax > max_abs or dmean > mean_abs:
        raise AssertionError("slice output differs from the plain versions' output")
    return ptimes


def run_slice(model, video, card: str):
    outs, times, launches, peak = drive(model, video, ("d2s_packed", "correlation",
                                                       "conv_chain", "rdb", "rdb_lff"),
                                        ("conv_chain_int8", "rdb_int8", "quantize_i8",
                                         "rdb_lff_i8", "conv_f32", "rdb_lff_f32"))
    steps = len(video) - 1
    if launches["rdb_lff"] != launches["rdb"] or launches["rdb"] != 8 * steps:
        raise AssertionError(f"bf16 slice launches {launches}: expected 8 rdb and 8 rdb_lff "
                             "per step")
    ptimes = against_plain(model, video, outs, SLICE_MAX_ABS, SLICE_MEAN_ABS)
    print(f"slice 1080p->2160p bf16 packed: {statistics.median(times):.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain (median of {len(times)} "
          f"steps; peak {peak:.2f} GiB) on {card}", flush=True)
    return outs, launches, statistics.median(times)


def psnr(a, b) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def run_int8_slice(model, video, bf16_outs, beside, card: str):
    """Calibrate and stream the int8 model; ``beside`` is (name, ms per frame)
    of the slice its time is printed beside. Returns (launches, ms per frame)."""
    calib = torch.stack(video[:3], dim=1)[:, :, :270, :480]
    t0 = time.perf_counter()
    quantize_sr(model, calib, device=calib.device)
    torch.cuda.synchronize()
    print(f"int8 calibration on {tuple(calib.shape)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    scheme = "per-channel int32_taps" if rdb_int8.PER_CHANNEL_INT8 else "per-column"
    int32 = ("rdb_int8_int32_taps",)
    outs, times, launches, peak = drive(
        model, video, ("d2s_packed", "correlation", "conv_chain_int8", "rdb_int8", "quantize_i8",
                       "rdb_lff_i8") + (int32 if rdb_int8.PER_CHANNEL_INT8 else ()),
        ("conv_chain", "rdb", "rdb_lff") + (() if rdb_int8.PER_CHANNEL_INT8 else int32))
    # Per step five chain sites (10 layers) and the RDB stack (8 blocks, 8
    # fusions), each quantising its input once; the prime runs the head
    # once more.
    steps = len(video) - 1
    want = {"conv_chain_int8": 10 * steps + 1, "rdb_int8": 8 * steps,
            "rdb_lff_i8": 8 * steps, "quantize_i8": 6 * steps + 1}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"int8 slice launches {launches}, expected {want}")
    # Each int8 state (five chain sites, the RDB stack) packs its weights at
    # its first call and keeps them: a frame after the first packs none.
    packs = dispatch.packs["int8"]
    print(f"int8 weight packs over {steps} steps: {packs} (one per int8 state)", flush=True)
    if packs != 6:
        raise AssertionError(f"the int8 slice packed weights {packs} times, expected 6")
    ptimes = against_plain(model, video, outs, INT8_MAX_ABS, INT8_MEAN_ABS)
    db = min(psnr(a, b) for a, b in zip(outs, bf16_outs))
    print(f"int8 {scheme} slice vs bf16 slice: PSNR {db:.2f} dB (least over {len(outs)} "
          f"frames; limit {INT8_MIN_PSNR})", flush=True)
    if db < INT8_MIN_PSNR:
        raise AssertionError(f"int8 output only {db:.2f} dB from the bf16 output")
    ms = statistics.median(times)
    print(f"slice 1080p->2160p int8 {scheme} packed: {ms:.1f} ms/frame with "
          f"kernels, {statistics.median(ptimes):.1f} ms/frame plain; {beside[0]} slice "
          f"{beside[1]:.1f} ms/frame (median of {len(times)} steps; peak {peak:.2f} GiB) "
          f"on {card}", flush=True)
    return launches, ms


def check_untrained_lightweight(dev, frame) -> float:
    """The zero-initialised tail makes the output the clipped bicubic
    upscale (the JAX gate's check, to 2⁻⁸: the model casts to bfloat16)."""
    model = LightweightSuperResolution(scale_factor=2, dtype=torch.bfloat16, device=dev,
                                       generator=torch.Generator().manual_seed(2)).eval()
    out = model(frame).float()
    bicubic = ops.pixel_shuffle(ops.upsample_bicubic_channels(frame, 2), 2).clamp(0.0, 1.0)
    err = (out - bicubic).abs().max().item()
    print(f"lightweight untrained vs clipped bicubic: max|d| {err:.3e} (limit {2**-8:.3e})",
          flush=True)
    if not err <= 2.0**-8:
        raise AssertionError("the untrained lightweight model is not the clipped bicubic")
    return err


def run_body(model, video, planar: bool):
    """The model's BN-folded body alone on each frame: per layer through
    ``ops.conv_chain_apply`` (NHWC), or in one launch through
    ``ops.planar_chain_apply`` (planar, its weight pack made once); the
    chain is folded once, before the frames. (residuals NHWC, ms per timed
    frame)."""
    outs, times = [], []
    with torch.inference_mode():
        chain = model.chain()
        pack = planar_chain.packed_planar_chain(chain, model.dtype, video[0].device)
        for frame in video:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = frame.to(model.dtype)
            if planar:
                y = ops.planar_chain_apply(x.permute(0, 3, 1, 2), chain, packed=pack)
                y = y.permute(0, 2, 3, 1)
            else:
                y = ops.conv_chain_apply(x, chain)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(y)
    return outs, times[1:]


def run_lightweight_slice(dev, video, card: str):
    """The lightweight slice (phase 7); returns the launch counts of its
    per-layer run and of its planar-chain run."""
    check_untrained_lightweight(dev, video[0])
    model = seeded_lightweight(dev, seed=0)
    nframes = len(video)
    outs, times, launches, peak = drive(
        model, video, ("conv_chain", "conv_chain_dw3", "d2s_packed"),
        ("correlation", "rdb", "conv_chain_int8", "rdb_int8", "planar_chain", "quantize_i8",
         "rdb_lff", "rdb_lff_i8"), run_frames)
    want = {"conv_chain": 6 * nframes, "conv_chain_dw3": 4 * nframes, "d2s_packed": nframes}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"lightweight launches {launches}, expected {want}")
    ptimes = against_plain(model, video, outs, LIGHT_MAX_ABS, LIGHT_MEAN_ABS, run_frames)
    print(f"slice lightweight 1080p->2160p bf16 packed: {statistics.median(times):.3f} ms/frame "
          f"with kernels, {statistics.median(ptimes):.3f} ms/frame plain (median of "
          f"{len(times)} frames; peak {peak:.2f} GiB) on {card}", flush=True)
    del outs
    # The body through the one-launch planar chain, against the per-layer body.
    dispatch.reset_launches()
    planar, ptimes = run_body(model, video, planar=True)
    planar_launches = dict(dispatch.launches)
    print(f"planar body launches {planar_launches}", flush=True)
    if planar_launches["planar_chain"] != nframes or sum(planar_launches.values()) != nframes:
        raise AssertionError("the planar body did not run one planar_chain launch per frame")
    layered, ltimes = run_body(model, video, planar=False)
    scale = max(y.float().abs().max().item() for y in layered)
    dmax = max((a.float() - b.float()).abs().max().item() for a, b in zip(planar, layered))
    print(f"lightweight body, planar chain vs per-layer kernels: max|d| {dmax:.3e} (limit "
          f"{PLANAR_BODY_REL * scale:.3e}); body {statistics.median(ptimes):.3f} ms/frame "
          f"planar chain, {statistics.median(ltimes):.3f} ms/frame per layer", flush=True)
    if not dmax <= PLANAR_BODY_REL * scale:
        raise AssertionError("the planar chain's body disagrees with the per-layer body")
    return model, launches, planar_launches


def run_per_channel_int8_slice(dev, video, bf16_outs, int8_ms, card: str):
    """Phase 6b: the int8 slice with per-channel scales and int32 taps."""
    saved = rdb_int8.PER_CHANNEL_INT8
    rdb_int8.PER_CHANNEL_INT8 = True
    try:
        # Built inside inference mode, as serving code may build it: its int8
        # state still packs once.
        with torch.inference_mode():
            model = seeded_model(dev, seed=0, quantized=True, quantized_chains=True)
        launches, _ms = run_int8_slice(model, video, bf16_outs,
                                       ("int8 per-column", int8_ms), card)
    finally:
        rdb_int8.PER_CHANNEL_INT8 = saved
    return launches


def run_diag_paths(dev):
    """Phase 6c: the diagnostic entry points' own timed paths, each with
    the counts set to 0 just before and read just after."""
    dispatch.reset_launches()
    g = torch.Generator().manual_seed(11)
    block = _common.rdb_params(g, FEATURES, dev, torch.bfloat16)
    x = _randn(g, (1, H, W, FEATURES)).to(dev, torch.bfloat16)
    diag_rdb.report(diag_rdb.attribution(x, block, reps=5, check=False),
                    f"one block, {H}x{W}x{FEATURES} bf16")
    rdb_launches = dict(dispatch.launches)
    print(f"diag rdb launches {rdb_launches}", flush=True)
    dispatch.reset_launches()
    diag_d2s.main([])
    d2s_launches = dict(dispatch.launches)
    print(f"diag d2s launches {d2s_launches}", flush=True)
    for name, launches in (("rdb_taps", rdb_launches), ("d2s_packed_planar", d2s_launches)):
        if launches[name] == 0:
            raise AssertionError(f"the diagnostic path launched no {name} kernel")
    return rdb_launches, d2s_launches


# --------------------------------------------------------------------------- #
# The engine (phase 8): recovery, flagship SR and strength blend, served
# through the channel-first facade and the enhance CLI
# --------------------------------------------------------------------------- #
ENGINE_CONFIG = EngineConfig(recovery_base_channels=64, recovery_temporal_window=2,
                             sr_num_features=FEATURES, sr_num_residual_blocks=BLOCKS,
                             sr_temporal_window=1, sr_flow_downsample=2)
ENGINE_MODES = ("full", "sr_only", "recovery_only", "lightweight")
# The mask: a 270 x 480 block of the 1080p centre frame.
MASK_ROWS, MASK_COLS = slice(405, 675), slice(720, 1200)
ENGINE_REPS = 3


def timed_calls(fn, reps: int = ENGINE_REPS):
    """(last result, median ms) of ``reps`` timed calls after one untimed,
    host clock to a synchronise."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def seeded_engine(dev, seed: int) -> api.EnhancementEngine:
    """The facade's bf16 engine at the full configuration, every parameter
    and BN statistic seeded (``seed_all``), strength 1."""
    eng = api.EnhancementEngine(ENGINE_CONFIG, seed=seed, dtype=torch.bfloat16, device=dev)
    seed_all(eng.module, seed)
    with torch.no_grad():
        eng.engine.enhancement_strength.fill_(1.0)
    return eng


def check_engine_outputs(out, video_f, mask) -> None:
    """Keys, shapes, finite values; ``enhanced`` in [0, 1] (strength 1);
    ``recovered`` the input exactly outside the mask."""
    b, _t, c, h, w = video_f.shape
    want = {"recovered": (b, c, h, w), "super_resolved": (b, c, 2 * h, 2 * w),
            "enhanced": (b, c, 2 * h, 2 * w)}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        raise AssertionError(f"engine outputs {got}, expected {want}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"engine output {k} not finite")
    if out["enhanced"].min() < 0 or out["enhanced"].max() > 1:
        raise AssertionError("engine output outside [0, 1] at strength 1")
    outside = mask[:, 0] == 0
    centre = video_f[:, video_f.shape[1] // 2]
    if not torch.equal(out["recovered"].permute(0, 2, 3, 1)[outside],
                       centre.permute(0, 2, 3, 1)[outside]):
        raise AssertionError("recovered differs from the input outside the mask")


def engine_inputs(dev, t: int, h: int, w: int, seed: int):
    """A seeded uint8 (1, t, 3, h, w) video on the card and a (1, 1, h, w)
    mask covering a quarter-by-quarter block of it."""
    g = torch.Generator().manual_seed(seed)
    video = torch.randint(0, 256, (1, t, 3, h, w), generator=g, dtype=torch.uint8).to(dev)
    mask = torch.zeros((1, 1, h, w), device=dev)
    mask[..., 3 * h // 8:5 * h // 8, 3 * w // 8:5 * w // 8] = 1.0
    return video, mask


def run_engine_phase(dev, card: str) -> dict:
    """Phase 8; returns the launch counts of one bf16 ``full`` call."""
    video, mask = engine_inputs(dev, 5, H, W, seed=21)
    assert mask[0, 0, MASK_ROWS, MASK_COLS].all() and int(mask.sum()) == 270 * 480
    video_f = api.from_uint8(video)
    eng = seeded_engine(dev, seed=0)
    with torch.inference_mode():
        eng(video, corruption_mask=mask)  # untimed
        torch.cuda.synchronize()
        dispatch.reset_launches()
        out = eng(video, corruption_mask=mask)
        torch.cuda.synchronize()
        launches = dict(dispatch.launches)
        print(f"engine launches per full call {launches}", flush=True)
        want = {"rdb": 8, "rdb_lff": 8}
        if any(launches[k] != n for k, n in want.items()) or launches["correlation"] < 1 \
                or launches["conv_chain"] == 0:
            raise AssertionError(f"engine launches {launches}: expected 8 rdb, 8 rdb_lff, "
                                 "a correlation and conv_chain")
        check_engine_outputs(out, video_f, mask)
        with plain_ops():
            dispatch.reset_launches()
            ref = eng(video, corruption_mask=mask)
            if any(dispatch.launches.values()):
                raise AssertionError(f"the plain engine launched kernels: {dispatch.launches}")
        for k in ("recovered", "super_resolved", "enhanced"):
            d = (out[k].float() - ref[k].float()).abs()
            print(f"engine {k} kernels vs plain: max|d| {d.max().item():.3e} (limit "
                  f"{SLICE_MAX_ABS}), mean|d| {d.mean().item():.3e} (limit {SLICE_MEAN_ABS})",
                  flush=True)
            if d.max() > SLICE_MAX_ABS or d.mean() > SLICE_MEAN_ABS:
                raise AssertionError(f"engine {k} differs from the plain versions' output")
        del ref
        # Each mode from the seeded full engine: a mode switch keeps the
        # weights the modes share (the lightweight net starts fresh, its tail
        # at zero) and drops the rest, as the reference's facade does.
        for mode in ENGINE_MODES:
            m = seeded_engine(dev, seed=0)
            m.set_enhancement_mode(mode)
            _o, ms = timed_calls(lambda: m(video, corruption_mask=mask))
            print(f"engine {mode} bf16 1080p->2160p: {ms:.2f} ms/call (median of "
                  f"{ENGINE_REPS}) on {card}", flush=True)
            del m, _o
        check_video(eng, dev, card)
        check_pair_step(eng.engine.super_resolution, video_f, card)
        run_engine_int8(eng, video, mask, out["enhanced"], card)
        del out
        run_adaptive(dev, video)
    check_cli(card)
    return launches


def check_video(eng, dev, card: str) -> None:
    """``enhance_video`` over 6 frames at 540 x 960 with a mask each, uint8 out."""
    video, mask = engine_inputs(dev, 6, H // 2, W // 2, seed=22)
    masks = mask.expand(6, 1, H // 2, W // 2)
    eng.enhance_video(video[0, :2], masks[:2], as_uint8=True)  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.enhance_video(video[0], masks, as_uint8=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if tuple(out.shape) != (6, 3, H, W) or out.dtype != torch.uint8:
        raise AssertionError(f"enhance_video gave {tuple(out.shape)} {out.dtype}")
    print(f"engine enhance_video 6 x 540x960 -> 1080x1920 uint8 with masks: "
          f"{6 / sec:.2f} frames/s on {card}", flush=True)


def check_pair_step(model, video_f, card: str, limits=(SLICE_MAX_ABS, SLICE_MEAN_ABS),
                    label: str = "") -> None:
    """``streaming_step_pair`` against two ``streaming_step`` calls on the
    video's 1080p frames, from the same carry, at ``limits`` (max, mean
    |Δ|; the bf16 slice's by default); ms per output frame of each."""
    max_abs, mean_abs = limits
    frames = [video_f[:, i].permute(0, 2, 3, 1).contiguous() for i in range(4)]
    carry = streaming_step(model, streaming_prime(model, frames[0]), frames[1])[0]

    def singles():
        c, a = streaming_step(model, carry, frames[2], "packed")
        return a, streaming_step(model, c, frames[3], "packed")[1]

    (a1, b1), ms1 = timed_calls(singles)
    (a2, b2), ms2 = timed_calls(
        lambda: streaming_step_pair(model, carry, frames[2], frames[3], "packed")[1])
    dmax = max((a1.float() - a2.float()).abs().max().item(),
               (b1.float() - b2.float()).abs().max().item())
    dmean = max((a1.float() - a2.float()).abs().mean().item(),
                (b1.float() - b2.float()).abs().mean().item())
    print(f"{label}streaming_step_pair vs two streaming_step: max|d| {dmax:.3e} (limit "
          f"{max_abs}), mean|d| {dmean:.3e} (limit {mean_abs}); "
          f"{ms1 / 2:.2f} ms/frame stepping, {ms2 / 2:.2f} ms/frame as a pair on {card}",
          flush=True)
    if dmax > max_abs or dmean > mean_abs:
        raise AssertionError("the pair step differs from two single steps")


def run_engine_int8(eng, video, mask, bf16_enhanced, card: str) -> None:
    """``quantize_int8(chains=True)`` calibrated on a 540 x 960 crop (the
    facade's zero mask): the int8 kernels launch, the bf16 dense and RDB
    kernels do not, six weight packs, PSNR against the bf16 engine (also
    outside the mask, printed)."""
    t0 = time.perf_counter()
    eng.quantize_int8(video[0, :, :, 270:810, 480:1440], chains=True)
    torch.cuda.synchronize()
    print(f"engine int8 calibration on 5 x 540x960: {time.perf_counter() - t0:.1f} s",
          flush=True)
    dispatch.reset_launches()
    out = eng(video, corruption_mask=mask)
    torch.cuda.synchronize()
    launches, packs = dict(dispatch.launches), dispatch.packs["int8"]
    print(f"engine int8 launches per full call {launches}; weight packs {packs}", flush=True)
    if any(launches[k] == 0 for k in ("conv_chain_int8", "rdb_int8", "rdb_lff_i8",
                                      "quantize_i8")) \
            or any(launches[k] for k in ("rdb", "conv_chain", "rdb_lff")) or packs != 6:
        raise AssertionError(f"engine int8 launches {launches}, packs {packs}")
    db = psnr(out["enhanced"], bf16_enhanced)
    outside = F.interpolate(mask, scale_factor=2.0)[:, 0] == 0
    db_out = psnr(out["enhanced"].permute(0, 2, 3, 1)[outside],
                  bf16_enhanced.permute(0, 2, 3, 1)[outside])
    print(f"engine int8 vs bf16 enhanced: PSNR {db:.2f} dB (limit {INT8_MIN_PSNR}); "
          f"outside the mask {db_out:.2f} dB", flush=True)
    if db < INT8_MIN_PSNR:
        raise AssertionError(f"int8 engine only {db:.2f} dB from the bf16 engine")
    for mode in ("full", "sr_only"):
        eng.set_enhancement_mode(mode)
        _o, ms = timed_calls(lambda: eng(video, corruption_mask=mask))
        print(f"engine {mode} int8 1080p->2160p: {ms:.2f} ms/call (median of {ENGINE_REPS}) "
              f"on {card}", flush=True)


def run_adaptive(dev, video) -> None:
    """The adaptive engine at budgets 0.2, 0.5, 0.9: its mode, complexity in
    [0, 1] and strength in [0.3, 1]."""
    eng = api.AdaptiveEnhancementEngine(ENGINE_CONFIG, seed=1, dtype=torch.bfloat16,
                                        device=dev)
    for budget, mode in ((0.2, "lightweight"), (0.5, "sr_only"), (0.9, "full")):
        out = eng(video, budget, 0.5)
        c, s = out["complexity"], float(out["enhancement_strength"])
        ok = (eng.config == ENGINE_CONFIG.with_mode(mode) and 0 <= c.min() <= c.max() <= 1
              and 0.3 <= s <= 1.0 and tuple(out["enhanced"].shape) == (1, 3, 2 * H, 2 * W)
              and bool(torch.isfinite(out["enhanced"]).all()))
        print(f"adaptive budget {budget}: mode {mode}, complexity {c.flatten().tolist()}, "
              f"strength {s:.4f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"adaptive engine at budget {budget}")


def engine_steppers(dev) -> dict:
    """Step functions for ``profile``: one bf16 engine call in "full" and in
    "recovery_only" mode on phase 8's window (the frame each is handed is
    not used)."""
    video, mask = engine_inputs(dev, 5, H, W, seed=21)
    steppers = {}
    for mode in ("full", "recovery_only"):
        eng = seeded_engine(dev, seed=0)
        eng.set_enhancement_mode(mode)
        steppers[f"engine {mode}"] = (lambda _frame, eng=eng:
                                      eng(video, corruption_mask=mask))
    return steppers


def check_cli(card: str) -> None:
    """``python -m nerve_tpu_torch.enhance`` on 4 uint8 frames at 270 x 480."""
    g = torch.Generator().manual_seed(23)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in.npy"), Path(tmp, "out.npy")
        np.save(src, torch.randint(0, 256, (4, 270, 480, 3), generator=g,
                                   dtype=torch.uint8).numpy())
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
        proc = subprocess.run(
            [sys.executable, "-m", "nerve_tpu_torch.enhance", str(src), "-o", str(dst),
             "--dtype", "bfloat16", "--sr-flow-downsample", "2"],
            capture_output=True, text=True, env=env, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"the enhance CLI failed: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        out = np.load(dst)
    print(f"enhance CLI: {json.dumps(summary)} on {card}", flush=True)
    if summary["output_shape"] != [4, 3, 540, 960] or out.dtype != np.uint8 \
            or summary["backend"] != "cuda":
        raise AssertionError(f"enhance CLI summary {summary}")


# --------------------------------------------------------------------------- #
# Training (phase 9): the kernel ops under autograd, the flagship train step
# against the plain versions, learning, resume and the training CLI
# --------------------------------------------------------------------------- #
# Output and gradients, kernel route vs plain route, (float32, bfloat16)
# relative to max|plain|: the kernels' forward levels above; the backward of
# both routes is the plain version's vjp at the same inputs. The warp has no
# kernel: its own backward (a float32 scatter, rounded once) against
# autograd's bfloat16 scatter, at the chain's level (measured on an H100:
# 8.1e-3 in bfloat16, 1.6e-7 in float32).
TRAIN_LIMITS = {"conv_chain": (1e-4, 2.4e-2), "rdb": (1e-4, 1.56e-2),
                "correlation": (1e-5, 1e-2), "warp": (1e-5, 2.4e-2)}
TRAIN_STEPS = 5
TRAIN_LOSS_REL = 2e-2  # kernel vs plain run, each step's loss (measured 3.4e-4)
# Parameters after TRAIN_STEPS steps, kernel vs plain run: max|Δ| relative to
# the largest parameter change, and the L2 norm of Δ relative to the change's
# (measured 0.72 and 6.2e-3 on an H100). AdamW moves each weight by about
# ±lr a step whatever its gradient's size, so a weight whose gradient is near
# 0 moves either way in the two runs: max|Δ| is of the order of the change.
TRAIN_PARAM_REL, TRAIN_PARAM_L2 = 1.0, 0.05
TRAIN_LAUNCHES = {"conv_chain": 10, "rdb": 8, "rdb_lff": 8, "correlation": 1}


def check_train_grads(dev) -> None:
    """Phase 9a: each kernel op under autograd against its plain version."""
    for dt in (torch.float32, torch.bfloat16):
        for name, (kernel, plain, leaves, g) in diag_train.grad_cases(dev, dt).items():
            dispatch.reset_launches()
            r = diag_train.compare_grads(kernel, plain, leaves, g)
            launched = {k: v for k, v in dispatch.launches.items() if v}
            limit = TRAIN_LIMITS[name][dt == torch.bfloat16]
            parts = [("output", r["forward"])] + [(f"grad {i}", st)
                                                   for i, st in enumerate(r["grads"])]
            worst = max(parts, key=lambda kv: kv[1]["max_abs"] / max(kv[1]["scale"], 1e-30))
            print(f"train grad {name} {str(dt)[6:]}: output max|d| "
                  f"{r['forward']['max_abs']:.3e} mean {r['forward']['mean_abs']:.3e} "
                  f"(max|plain| {r['forward']['scale']:.3e}); worst of {len(r['grads'])} "
                  f"gradients: {worst[0]} max|d| {worst[1]['max_abs']:.3e} mean "
                  f"{worst[1]['mean_abs']:.3e} (max|plain| {worst[1]['scale']:.3e}); limit "
                  f"{limit} of max|plain|; launches {launched}", flush=True)
            for label, st in parts:
                if not st["max_abs"] <= limit * st["scale"]:
                    raise AssertionError(f"train {name} {dt}: {label} differs from the plain "
                                         "version's")
            if name != "warp" and not launched:
                raise AssertionError(f"train {name}: the kernel route launched no kernel")


def _train_run(model, batches, plain: bool):
    """TRAIN_STEPS steps: (state, step, losses, launches of each step)."""
    state, step = diag_train.step_fn(model, steps=TRAIN_STEPS + 1)
    losses, launches = [], []
    with plain_ops() if plain else contextlib.nullcontext():
        for batch in batches[:TRAIN_STEPS]:
            dispatch.reset_launches()
            _s, metrics = step(state, *batch)
            torch.cuda.synchronize()
            losses.append(metrics["loss"].item())
            launches.append({k: v for k, v in dispatch.launches.items() if v})
    return state, step, losses, launches


def check_train_steps(dev, card: str, batches):
    """Phase 9b: the flagship train step, kernels against plain versions;
    returns the kernel run's (model, state, step) and its launches per step."""
    model = diag_train.train_model(dev, seed=0)
    p0 = [p.detach().clone() for p in model.parameters()]
    state, step, losses, launches = _train_run(model, batches, plain=False)
    print(f"train step launches {launches[0]} (each of {TRAIN_STEPS} steps)", flush=True)
    if any(lc != TRAIN_LAUNCHES for lc in launches):
        raise AssertionError(f"train step launches {launches}, expected {TRAIN_LAUNCHES}")
    plain_model = diag_train.train_model(dev, seed=0)
    _ps, _pstep, plosses, plaunches = _train_run(plain_model, batches, plain=True)
    if any(plaunches):
        raise AssertionError(f"the plain train steps launched kernels: {plaunches}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plosses)]
    print(f"train losses kernels {losses}, plain {plosses}: max rel {max(rel):.3e} (limit "
          f"{TRAIN_LOSS_REL})", flush=True)
    if not all(math.isfinite(v) for v in losses + plosses) or max(rel) > TRAIN_LOSS_REL:
        raise AssertionError("the kernel run's losses differ from the plain run's")
    with torch.no_grad():
        pk = torch.cat([p.flatten() for p in model.parameters()])
        pp = torch.cat([p.flatten() for p in plain_model.parameters()])
        change = pk - torch.cat([p.flatten() for p in p0])
        d = (pk - pp).abs()
        dmax, cmax = d.max().item(), change.abs().max().item()
        dl2, cl2 = d.norm().item(), change.norm().item()
    print(f"train params after {TRAIN_STEPS} steps, kernels vs plain: max|d| {dmax:.3e} = "
          f"{dmax / cmax:.3e} of the largest change {cmax:.3e} (limit {TRAIN_PARAM_REL}); "
          f"L2 {dl2:.3e} = {dl2 / cl2:.3e} of the change's {cl2:.3e} (limit {TRAIN_PARAM_L2}); "
          f"mean|d| {d.mean().item():.3e}", flush=True)
    if not (dmax <= TRAIN_PARAM_REL * cmax and dl2 <= TRAIN_PARAM_L2 * cl2):
        raise AssertionError("the kernel run's parameters differ from the plain run's")
    timing = diag_train.train_step_timing(model, batches[0])
    print(f"train step 64/8 bf16 batch {diag_train.BATCH} "
          f"{diag_train.LR_SIZE}^2->{2 * diag_train.LR_SIZE}^2: {timing['ms_per_step']:.2f} "
          f"ms/step (median of 20 after 3 untimed; min {timing['ms_min']:.2f}, max "
          f"{timing['ms_max']:.2f}), {timing['samples_per_s']:.1f} samples/s, peak "
          f"{timing['peak_bytes'] / 2**30:.2f} GiB allocated, on {card}", flush=True)
    return model, state, step, launches[0]


def check_learning(dev, card: str) -> None:
    """Phase 9c: ``fit_sr`` from the model's own initialisation."""
    g = torch.Generator().manual_seed(3)
    train_data = data_lib.make_video_sr_dataset(g, 64, diag_train.LR_SIZE)
    val_data = data_lib.make_video_sr_dataset(g, 16, diag_train.LR_SIZE)
    model = SuperResolutionNet(scale_factor=2, num_features=FEATURES, num_residual_blocks=BLOCKS,
                               temporal_window=1, dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator().manual_seed(4))
    cfg = TrainingConfig(epochs=3, batch_size=diag_train.BATCH, learning_rate=3e-3,
                         warmup_epochs=0)
    t0 = time.perf_counter()
    _state, hist = training.fit_sr(model, train_data, val_data, cfg, 3, seed=0,
                                   log_fn=lambda s: print(f"fit_sr {s}", flush=True))
    per = len(hist["losses"]) // cfg.epochs
    first, last = (statistics.mean(hist["losses"][:per]),
                   statistics.mean(hist["losses"][-per:]))
    print(f"fit_sr 3 epochs x {per} steps: losses {hist['losses']}; epoch means {first:.5f} "
          f"-> {last:.5f}; best val PSNR {hist['best_psnr']:.2f} dB; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    if not all(math.isfinite(v) for v in hist["losses"]) or not last < first:
        raise AssertionError("fit_sr did not learn: a loss is not finite or the loss rose")


def check_resume(dev, state, step, batch) -> None:
    """Phase 9d: save, restore into a fresh model and optimiser, one more step."""
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep_last_n=1)
        mgr.save(state.step, {**state.state_dict(), "best_psnr": -1.0})
        _s, metrics = step(state, *batch)
        fresh = diag_train.train_model(dev, seed=9)
        fstate, fstep = diag_train.step_fn(fresh, steps=TRAIN_STEPS + 1)
        template = {**fstate.state_dict(), "best_psnr": -1.0}
        fstate.load_state_dict(mgr.restore(template))
        _f, fmetrics = fstep(fstate, *batch)
    loss, floss = metrics["loss"], fmetrics["loss"]
    print(f"train resume at step {fstate.step - 1}: loss {loss.item()!r} uninterrupted, "
          f"{floss.item()!r} restored", flush=True)
    if not torch.equal(loss, floss):
        raise AssertionError("the restored trainer's loss differs from the uninterrupted run's")


def check_train_cli(card: str) -> None:
    """Phase 9e: ``python -m nerve_tpu_torch.train_baseline`` at 64/8."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nerve_tpu_torch.train_baseline", "--epochs", "1",
             "--train-samples", "32", "--val-samples", "16", "--num-features", "64",
             "--num-blocks", "8", "--checkpoint-dir", str(Path(tmp, "ck"))],
            capture_output=True, text=True, env=env, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the train_baseline CLI failed: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"train_baseline CLI: {json.dumps(summary)} in {time.perf_counter() - t0:.1f} s "
          f"on {card}", flush=True)
    if set(summary) != {"best_psnr", "final_psnr"} or not math.isfinite(summary["final_psnr"]):
        raise AssertionError(f"train_baseline summary {summary}")


def run_train_phase(dev, card: str, profile_dir=None) -> dict:
    """Phase 9; returns the launches of one train step."""
    check_train_grads(dev)
    batches = diag_train.train_batches(dev, TRAIN_STEPS + 1)
    model, state, step, launches = check_train_steps(dev, card, batches)
    check_resume(dev, state, step, batches[TRAIN_STEPS])
    if profile_dir is not None:
        diag_train.profile_split(model, batches[0], Path(profile_dir))
    del model, state, step
    check_learning(dev, card)
    check_train_cli(card)
    return launches


# --------------------------------------------------------------------------- #
# Continual learning (phase 10): second derivatives through the kernel ops,
# the continual library at the flagship's width, the continual CLI
# --------------------------------------------------------------------------- #
# The Hessian-vector products are held at TRAIN_LIMITS: the second
# derivatives of both routes are the plain version's at the same inputs,
# only the forward (and the warp's own backward) differ. The experiment's
# widths: B, H, W, C, RDB blocks, growth (a 176-channel block concatenation).
CONTINUAL_DIMS = {"small": None, "experiment": (16, 32, 32, 16, 2, 32)}
# The continual library, kernel route vs plain route, relative L2 norm of
# each loss, Fisher, importance and meta-gradient. float32 with TF32 off:
# the two forwards differ by summation order (~1e-6 of each output), which
# the Fisher squares and the meta-gradient carries through two
# differentiations (measured ≤ 1.5e-7 on an H100); a wrong tap, block or
# dropped second-order term moves these by 1e-2 or more (the second-order
# term alone is printed: 0.17 at 64/8, inner rate 0.01).
CONTINUAL_L2 = 1e-3
CONTINUAL_LAUNCHES = ("conv_chain", "rdb", "rdb_lff", "correlation", "conv_f32", "rdb_lff_f32")
FLOAT32_ROW_REL = 1e-4  # the float32 rows' kernels vs plain, of max|plain| (TF32 off)
CONTINUAL_STRATEGIES = ("ewc", "replay", "si", "maml", "reptile")


def _worst(stats):
    return max(range(len(stats)),
               key=lambda i: stats[i]["max_abs"] / max(stats[i]["scale"], 1e-30))


def check_continual_hvps(dev) -> None:
    """Phase 10a: second derivatives through each kernel op."""
    for label, dims in CONTINUAL_DIMS.items():
        for dt in (torch.float32, torch.bfloat16):
            cases = diag_train.grad_cases(dev, dt, small=dims is None, dims=dims)
            for name, (kernel, plain, leaves, g) in cases.items():
                limit = TRAIN_LIMITS[name][dt == torch.bfloat16]
                checks = []
                if dims is not None:  # this width's forward and gradients too
                    r = diag_train.compare_grads(kernel, plain, leaves, g)
                    checks += [("output", r["forward"])] + [(f"grad {i}", st) for i, st
                                                            in enumerate(r["grads"])]
                dispatch.reset_launches()
                stats = diag_continual.compare_hvp(kernel, plain, leaves, g)
                launched = {k: v for k, v in dispatch.launches.items() if v}
                checks += [(f"second derivative {i}", st) for i, st in enumerate(stats)]
                w = _worst(stats)
                print(f"continual hvp {name} {label} {str(dt)[6:]}: worst of {len(stats)} "
                      f"second derivatives: {w} max|d| {stats[w]['max_abs']:.3e} mean "
                      f"{stats[w]['mean_abs']:.3e} (max|plain| {stats[w]['scale']:.3e}); "
                      f"limit {limit} of max|plain|; launches {launched}", flush=True)
                for i, st in enumerate(stats):
                    if st["mismatch"]:
                        raise AssertionError(f"continual {name} {label} {dt}: second "
                                             f"derivative {i} missing on one route")
                for what, st in checks:
                    if not st["max_abs"] <= limit * st["scale"]:
                        raise AssertionError(f"continual {name} {label} {dt}: {what} differs "
                                             "from the plain version's")
                if name != "warp" and not launched:
                    raise AssertionError(f"continual {name}: the kernel route launched no kernel")


def _param_rule(name, got, want, p0) -> None:
    """Phase 9's rule for the parameters after a step, kernel vs plain."""
    pk, pp, base = (diag_continual.flat(x) for x in (got, want, p0))
    change, d = pk - base, (pk - pp).abs()
    dmax, cmax = d.max().item(), change.abs().max().item()
    dl2, cl2 = d.norm().item(), change.norm().item()
    print(f"{name}: max|d| {dmax:.3e} = {dmax / cmax:.3e} of the largest change "
          f"(limit {TRAIN_PARAM_REL}); L2 {dl2:.3e} = {dl2 / cl2:.3e} of the change's "
          f"(limit {TRAIN_PARAM_L2})", flush=True)
    if not (cmax > 0 and dmax <= TRAIN_PARAM_REL * cmax and dl2 <= TRAIN_PARAM_L2 * cl2):
        raise AssertionError(f"{name}: the kernel run's parameters differ from the plain "
                             "run's")


def check_continual_library(dev, card: str) -> dict:
    """Phase 10b; returns the second-order meta step's launches."""
    model = diag_continual.continual_model(dev)
    batches = diag_continual.continual_batches(dev)
    kern = diag_continual.library_run(model, batches)
    with plain_ops():
        plain = diag_continual.library_run(model, batches)
    launches = kern["maml launches"]
    print(f"continual second-order MAML step launches {launches}; plain route "
          f"{plain['maml launches']}", flush=True)
    if plain["maml launches"] or not all(launches.get(k) for k in CONTINUAL_LAUNCHES):
        raise AssertionError(f"continual meta step launches {launches}, plain "
                             f"{plain['maml launches']}: expected {CONTINUAL_LAUNCHES}")
    for key, got in kern.items():
        if key in ("maml launches", "p0"):
            continue
        if key.endswith("params"):
            _param_rule(f"continual {key}", got, plain[key], kern["p0"])
            continue
        r = diag_continual.rel_l2(got, plain[key])
        print(f"continual {key}: kernel vs plain relative L2 {r:.3e} (limit {CONTINUAL_L2})",
              flush=True)
        if not r <= CONTINUAL_L2:
            raise AssertionError(f"continual {key}: the kernel route differs from the plain")
    second = diag_continual.rel_l2(kern["fomaml meta-gradient"], kern["maml meta-gradient"])
    print(f"continual: the first-order meta-gradient differs from the second-order one by "
          f"{second:.3e} in relative L2 (the size of a dropped second-order term; limit above "
          f"{CONTINUAL_L2})", flush=True)
    if not second > CONTINUAL_L2:
        raise AssertionError("continual: the second-order term is below the check's bound")
    t = diag_continual.library_timing(model, batches)
    print(f"continual 64/8 float32 LR {diag_continual.LR_SIZE}^2 batch {diag_continual.BATCH}, "
          f"2 tasks x 1 inner step: second-order meta step {t['maml_ms']:.2f} ms, first-order "
          f"{t['fomaml_ms']:.2f} ms; Fisher pass over one batch {t['fisher_ms']:.2f} ms, "
          f"per-sample {t['per_sample_fisher_ms']:.2f} ms (medians of 3 after 1); peak "
          f"{t['maml_peak_bytes'] / 2**30:.2f} GiB allocated in the second-order step; on "
          f"{card}", flush=True)
    return launches


def check_continual_cli(card: str) -> None:
    """Phase 10c: ``python -m nerve_tpu_torch.train_continual`` per strategy,
    the five at once."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    procs = {}
    try:
        for s in CONTINUAL_STRATEGIES:
            procs[s] = subprocess.Popen(
                [sys.executable, "-m", "nerve_tpu_torch.train_continual", "--strategy", s,
                 "--num-tasks", "2", "--epochs-per-task", "1", "--samples-per-task", "16",
                 "--batch-size", "8"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)
        for s, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"train_continual --strategy {s} failed: {err[-2000:]}")
            scores = json.loads(out.strip().splitlines()[-1])["final_psnr_per_task"]
            print(f"train_continual --strategy {s}: {json.dumps(scores)}", flush=True)
            if len(scores) != 2 or not all(math.isfinite(v) for v in scores.values()):
                raise AssertionError(f"train_continual --strategy {s}: PSNRs {scores}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"train_continual CLI, five strategies in parallel: "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def run_continual_phase(dev, card: str):
    """Phase 10; returns the launches of one second-order meta step and the
    float32 rows (``diag.continual.float32_rows``)."""
    check_continual_hvps(dev)
    launches = check_continual_library(dev, card)
    check_continual_cli(card)
    print(f"float32 route at the meta step's shapes on {card}:", flush=True)
    rows = diag_continual.float32_rows(dev)
    for name, r in rows.items():
        if not r["launches"] or r["rel_err"] > FLOAT32_ROW_REL:
            raise AssertionError(f"float32 {name}: launches {r['launches']}, error "
                                 f"{r['rel_err']:.3e} of max|plain|")
    return launches, rows


# --------------------------------------------------------------------------- #
# Federated (phase 11): the lightweight model's training through its
# kernels, one FedAvg round, the CLI's four modes
# --------------------------------------------------------------------------- #
# Kernel route vs plain route, float32 with TF32 off. Outputs, losses and
# BatchNorm statistics: the conv chain's float32 level, relative to
# max|plain| per tensor. Gradients: all of a step's together in relative L2
# at that level, and each tensor within FED_GRAD_TENSOR of its max|plain|:
# a BatchNorm bias's or scale's gradient is a sum over B·H·W terms that
# cancel (measured 1.26e-4 of max|plain| on an H100 for body1's bias in the
# train step at batch 8, 64²: 32,768 terms summing to 2.8e-3).
FED_LIMIT = 1e-4
FED_GRADS_L2 = 1e-4
FED_GRAD_TENSOR = 1e-3
FED_STEP_LAUNCHES = {"train": {"forward": {"conv_chain": 2, "conv_f32": 2}, "backward": {}},
                     "frozen_stats": {"forward": {"conv_chain": 6, "conv_f32": 6,
                                                  "conv_chain_dw3": 4},
                                      "backward": {}}}
FED_CLIENT_STEPS = 5
FED_LOSS_REL = 1e-4  # each client step's loss, kernel vs plain route
FED_NORM_REL = 1e-3  # the round's update_norm, kernel vs plain route


def check_fed_steps(dev) -> None:
    """Phase 11a."""
    model = diag_fed.fed_model(dev)
    for lr_size in diag_fed.FIT_LR_SIZES:
        lr, hr = diag_fed.client_batch(dev, lr_size)
        launches = diag_fed.step_launches(model, lr, hr)
        print(f"federated step launches LR {lr_size}^2 batch {diag_fed.BATCH}: "
              f"{json.dumps(launches)}", flush=True)
        if launches != FED_STEP_LAUNCHES:
            raise AssertionError(f"federated step launches {launches}, expected "
                                 f"{FED_STEP_LAUNCHES}")
        for kind, tensors in diag_fed.compare_routes(model, lr, hr).items():
            l2 = diag_fed.grads_rel_l2(tensors)
            for group in ("grad", "other"):
                part = {k: v for k, v in tensors.items() if k.startswith("grad ") == (
                    group == "grad")}
                name, st = max(part.items(),
                               key=lambda kv: kv[1]["max_abs"] / max(kv[1]["scale"], 1e-30))
                limit = FED_GRAD_TENSOR if group == "grad" else FED_LIMIT
                what = "gradients" if group == "grad" else "outputs, losses, statistics"
                print(f"federated {kind} step LR {lr_size}^2 float32, kernel vs plain route, "
                      f"{len(part)} {what}: worst {name} max|d| {st['max_abs']:.3e} = "
                      f"{st['max_abs'] / max(st['scale'], 1e-30):.3e} of max|plain| "
                      f"{st['scale']:.3e} (limit {limit}); mean {st['mean_abs']:.3e}", flush=True)
                for k, t in part.items():
                    if not t["max_abs"] <= limit * t["scale"]:
                        raise AssertionError(f"federated {kind} step: {k} differs from the "
                                             "plain route's")
            print(f"federated {kind} step LR {lr_size}^2: the gradients' relative L2 "
                  f"{l2:.3e} (limit {FED_GRADS_L2})", flush=True)
            if not l2 <= FED_GRADS_L2:
                raise AssertionError(f"federated {kind} step: the gradients differ from the "
                                     "plain route's")
    data = client_dataset(0, diag_fed.SAMPLES, diag_fed.SEED)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    pk, lk = diag_fed.client_steps(model, data, FED_CLIENT_STEPS)
    pp, lp = diag_fed.client_steps(model, data, FED_CLIENT_STEPS, plain=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    print(f"federated client {FED_CLIENT_STEPS} AdamW steps: losses kernels {lk}, plain "
          f"{lp}: max rel {rel:.3e} (limit {FED_LOSS_REL})", flush=True)
    if not all(math.isfinite(v) for v in lk + lp) or rel > FED_LOSS_REL:
        raise AssertionError("the federated client's losses differ between the routes")
    _param_rule(f"federated client after {FED_CLIENT_STEPS} steps", pk, pp, p0)


def check_fed_round(dev) -> dict:
    """Phase 11b; returns the launches of one round."""
    model = diag_fed.fed_model(dev)
    data = stacked_client_data(diag_fed.CLIENTS, diag_fed.SAMPLES, diag_fed.SEED, dev)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    pk, mk, lk = diag_fed.round_run(model, data, diag_fed.LOCAL_STEPS)
    pp, mp, lp = diag_fed.round_run(model, data, diag_fed.LOCAL_STEPS, plain=True)
    steps = diag_fed.CLIENTS * diag_fed.LOCAL_STEPS
    want = {k: steps * v for k, v in FED_STEP_LAUNCHES["frozen_stats"]["forward"].items()}
    rel = abs(mk["update_norm"] - mp["update_norm"]) / mp["update_norm"]
    print(f"federated round {diag_fed.CLIENTS} clients x {diag_fed.LOCAL_STEPS} local steps: "
          f"launches {lk} (plain route {lp}); update_norm kernels {mk['update_norm']!r}, "
          f"plain {mp['update_norm']!r}: rel {rel:.3e} (limit {FED_NORM_REL})", flush=True)
    if lk != want or lp:
        raise AssertionError(f"federated round launches {lk}, plain {lp}: expected {want}")
    if not (math.isfinite(mk["update_norm"]) and rel <= FED_NORM_REL):
        raise AssertionError("the round's update_norm differs between the routes")
    _param_rule("federated round", pk, pp, p0)
    norms = diag_fed.delta_norms(model, data, diag_fed.LOCAL_STEPS, None)
    cap = 0.5 * min(norms)
    clipped = diag_fed.delta_norms(model, data, diag_fed.LOCAL_STEPS,
                                   PrivacyConfig(max_grad_norm=cap, noise_multiplier=0.1))
    print(f"federated DP clip at C = {cap:.4e} (half the smallest of the delta norms "
          f"{[f'{v:.4e}' for v in norms]}): clipped norms {[f'{v:.4e}' for v in clipped]}",
          flush=True)
    if not (max(clipped) <= cap * (1 + 1e-5) and max(clipped) >= cap * (1 - 1e-3)):
        raise AssertionError("a clipped client delta's norm is not C")
    _pd, md, _ld = diag_fed.round_run(model, data, diag_fed.LOCAL_STEPS, privacy=PrivacyConfig(
        max_grad_norm=cap, noise_multiplier=0.1))
    if not math.isfinite(md["update_norm"]):
        raise AssertionError(f"the DP round's metrics {md}")
    return lk


def _client0_losses(text: str) -> list:
    return [float(m) for m in re.findall(r"client0_loss=(\S+)", text)]


def check_fed_cli(card: str) -> None:
    """Phase 11c: the four modes at once."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    with socket.socket() as probe_sock:
        probe_sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{probe_sock.getsockname()[1]}"
    runs = {"simulation": [], "trainer": ["--num-rounds", "2"],
            "server": ["--server-address", address, "--num-rounds", "1",
                       "--wait-timeout", "60"],
            "client 0": ["--server-address", address, "--client-id", "0"],
            "client 1": ["--server-address", address, "--client-id", "1"]}
    t0 = time.perf_counter()
    procs, outs = {}, {}
    try:
        for name, extra in runs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "nerve_tpu_torch.train_federated", "--mode",
                 name.split()[0], *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"train_federated --mode {name} failed: {err[-2000:]}")
            outs[name] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in ("simulation", "trainer"):
        summary = json.loads(outs[name].strip().splitlines()[-1])
        print(f"train_federated --mode {name}: {json.dumps(summary)}", flush=True)
        if not math.isfinite(summary["final_loss"]):
            raise AssertionError(f"train_federated --mode {name}: {summary}")
    losses = _client0_losses(outs["simulation"])
    print(f"train_federated --mode simulation client 0 losses by round {losses}", flush=True)
    if not (len(losses) == 5 and losses[-1] < losses[0]):
        raise AssertionError("the simulation's client-0 loss did not fall from round 1 to 5")
    rounds = [ln for ln in outs["server"].splitlines() if ln.startswith("round 1:")]
    print(f"train_federated --mode server with 2 clients: {rounds}", flush=True)
    loss = re.search(r"'train_loss': ([^,}]+)", rounds[0]) if rounds else None
    if loss is None or not math.isfinite(float(loss.group(1))):
        raise AssertionError(f"the server's round: {outs['server'][-2000:]}")
    print(f"train_federated CLI, four modes in parallel: {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)


def run_federated_phase(dev, card: str):
    """Phase 11; returns the launches of one round and the float32 layers
    (``diag.federated.float32_layers``)."""
    check_fed_steps(dev)
    launches = check_fed_round(dev)
    check_fed_cli(card)
    print(f"float32 route of the conv chain's kernels on {card}:", flush=True)
    layers = diag_fed.float32_layers(dev)
    for name, r in layers.items():
        want = "conv_chain_dw3" if name.startswith("dw3") else "conv_f32"
        if r["launches"].get(want) != 1 or r["rel_err"] > FLOAT32_ROW_REL:
            raise AssertionError(f"float32 {name}: launches {r['launches']}, error "
                                 f"{r['rel_err']:.3e} of max|plain|")
    t = diag_fed.timing(dev)
    print(f"federated lightweight float32: FedAvg round at the CLI's defaults "
          f"({diag_fed.CLIENTS} clients x {diag_fed.LOCAL_STEPS} local steps, "
          f"{diag_fed.SAMPLES} samples at LR 16^2) {t['round_ms']:.2f} ms, launches "
          f"{t['round_launches']}; client fit (1 epoch, batch {diag_fed.BATCH}, "
          f"{diag_fed.SAMPLES} samples) LR 16^2 {t['fit_ms_16']:.2f} ms, LR 64^2 "
          f"{t['fit_ms_64']:.2f} ms, peak {t['fit_peak_bytes_64'] / 2**20:.1f} MiB allocated "
          f"(medians of 3 after 1); on {card}", flush=True)
    return launches, layers


# --------------------------------------------------------------------------- #
# Recovery and checkpoints (phase 12): the recovery net's training, its
# protocol CLI, nerve_cl and train_baseline checkpoints through the enhance
# CLI, the int8 engine's pair step and training mode, BatchNorm gradients
# against float64
# --------------------------------------------------------------------------- #
# One recovery train step, card vs CPU (float32, TF32 off): the loss
# relative, each gradient in relative L2 (or, over that, no further from
# the step in float64 on the card than the CPU's is), each running
# statistic relative to max|CPU|.
RECOVERY_LOSS_REL, RECOVERY_GRAD_L2, RECOVERY_STAT_REL = 1e-5, 1e-4, 1e-5
CLI_TIMEOUT = 600


def _conv_oihw(k):
    return np.transpose(k, (3, 2, 0, 1))


class NerveClExport:
    """Flax-shaped engine variables → a nerve_cl state dict: the inverse of
    ``models.import_torch`` (OIHW, Conv3d, ConvTranspose2d's (in, out)
    layout with unflipped taps, Linear's (out, in), the LFF as a 1 × 1 conv,
    BatchNorm's running statistics and counter), kept here apart from the
    package it checks."""

    def __init__(self, variables):
        from nerve_tpu_torch.models.bridge import _flatten

        self.params = _flatten(variables["params"])
        self.stats = _flatten(variables["batch_stats"])
        self.sd = {}

    def put(self, key, value):
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    def p(self, path):
        return self.params.pop(path.replace("/", "."))

    def conv(self, tk, fp, bias=True):
        self.put(f"{tk}.weight", _conv_oihw(self.p(f"{fp}/kernel")))
        if bias:
            self.put(f"{tk}.bias", self.p(f"{fp}/bias"))

    def bn(self, tk, fp):
        self.put(f"{tk}.weight", self.p(f"{fp}/scale"))
        self.put(f"{tk}.bias", self.p(f"{fp}/bias"))
        for ours, theirs in (("mean", "running_mean"), ("var", "running_var")):
            self.put(f"{tk}.{theirs}", self.stats.pop(f"{fp}/{ours}".replace("/", ".")))
        self.sd[f"{tk}.num_batches_tracked"] = torch.tensor(1)

    def dwsep(self, tk, fp):
        for part in ("depthwise", "pointwise"):
            self.put(f"{tk}.{part}.weight", _conv_oihw(self.p(f"{fp}/{part}/kernel")))
        self.bn(f"{tk}.bn", f"{fp}/BatchNorm_0")

    def residual_block(self, tk, fp):
        self.dwsep(f"{tk}.conv1", f"{fp}/conv1")
        self.put(f"{tk}.conv2.0.weight", _conv_oihw(self.p(f"{fp}/conv2_dw/kernel")))
        self.put(f"{tk}.conv2.1.weight", _conv_oihw(self.p(f"{fp}/conv2_pw/kernel")))
        self.bn(f"{tk}.conv2.2", f"{fp}/bn2")

    def cbam(self, tk, fp):
        for i, j in ((0, 0), (1, 2)):
            self.put(f"{tk}.channel_attention.fc.{j}.weight",
                     self.p(f"{fp}/ChannelAttention_0/Dense_{i}/kernel").T)
        self.put(f"{tk}.spatial_attention.conv.weight",
                 _conv_oihw(self.p(f"{fp}/SpatialAttention_0/conv_kernel")))

    def engine(self, cfg: EngineConfig) -> dict:
        fr, se = "frame_recovery", "frame_recovery.spatial_encoder"
        self.conv(f"{se}.stem.0", f"{fr}/spatial_encoder/stem", bias=False)
        self.bn(f"{se}.stem.1", f"{fr}/spatial_encoder/stem_bn")
        for st in (1, 2, 3):
            if st > 1:
                self.conv(f"{se}.stage{st}.0.0", f"{fr}/spatial_encoder/stage{st}_down", False)
                self.bn(f"{se}.stage{st}.0.1", f"{fr}/spatial_encoder/stage{st}_down_bn")
            for i in range(2):
                self.residual_block(f"{se}.stage{st}.{i + (st > 1)}",
                                    f"{fr}/spatial_encoder/stage{st}_block{i}")
        self.cbam(f"{se}.attention", f"{fr}/spatial_encoder/attention")
        for i in (1, 2, 3):
            for part in ("spatial", "temporal"):
                k = self.p(f"{fr}/temporal_encoder/conv{i}/{part}/kernel")
                self.put(f"{fr}.temporal_encoder.conv{i}.{part}.0.weight",
                         np.transpose(k, (4, 3, 0, 1, 2)))
                self.bn(f"{fr}.temporal_encoder.conv{i}.{part}.1",
                        f"{fr}/temporal_encoder/conv{i}/{part}_bn")
        self.conv(f"{fr}.fusion.align", f"{fr}/fusion/align")
        self.conv(f"{fr}.fusion.attention.0", f"{fr}/fusion/attn0")
        self.conv(f"{fr}.fusion.attention.2", f"{fr}/fusion/attn1")
        for proj in ("spatial_proj", "temporal_proj"):  # nerve_cl's constants: no entry
            self.p(f"{fr}/fusion/{proj}/kernel")
        for i in range(2):
            self.residual_block(f"{fr}.fusion.refine.{i}", f"{fr}/fusion/refine{i}")
        self.cbam(f"{fr}.fusion.refine.2", f"{fr}/fusion/refine_cbam")
        for i in (1, 2, 3, 4):
            k = self.p(f"{fr}/decoder/up{i}/kernel")
            self.put(f"{fr}.decoder.up{i}.0.weight", np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
            self.bn(f"{fr}.decoder.up{i}.1", f"{fr}/decoder/up{i}_bn")
        self.conv(f"{fr}.decoder.final.0", f"{fr}/decoder/final")
        sr, fe = "super_resolution", "super_resolution.feature_extractor"
        self.conv(f"{fe}.head.0", f"{sr}/feature_extractor/head")
        for i in range(3):
            self.dwsep(f"{fe}.body.{i}", f"{sr}/feature_extractor/body{i}")
        for i, j in enumerate((0, 2, 4, 6)):
            self.conv(f"{sr}.motion_estimator.flow_net.{j}", f"{sr}/motion_estimator/flow{i}")
        for i, j in enumerate((0, 2, 4)):
            self.conv(f"{sr}.temporal_aggregator.attention.{j}",
                      f"{sr}/temporal_aggregator/attn{i}")
        self.cbam(f"{sr}.temporal_aggregator.refine", f"{sr}/temporal_aggregator/refine")
        for b in range(cfg.sr_num_residual_blocks):
            for i in range(5):
                self.put(f"{sr}.residual_blocks.{b}.layers.{i}.0.weight",
                         _conv_oihw(self.p(f"{sr}/rdbs/rdb{b}_dense{i}_kernel")))
                self.put(f"{sr}.residual_blocks.{b}.layers.{i}.0.bias",
                         self.p(f"{sr}/rdbs/rdb{b}_dense{i}_bias"))
            self.put(f"{sr}.residual_blocks.{b}.lff.weight",
                     self.p(f"{sr}/rdbs/rdb{b}_lff_kernel").T[:, :, None, None])
            self.put(f"{sr}.residual_blocks.{b}.lff.bias", self.p(f"{sr}/rdbs/rdb{b}_lff_bias"))
        self.conv(f"{sr}.gff.0", f"{sr}/gff")
        self.conv(f"{sr}.upsampler.conv", f"{sr}/upsampler/conv")
        self.put("enhancement_strength", self.p("enhancement_strength").reshape(()))
        if self.params or self.stats:
            raise AssertionError(f"not exported: {sorted(self.params)[:4]} "
                                 f"{sorted(self.stats)[:4]}")
        return self.sd


def _run(cmd, timeout=CLI_TIMEOUT):
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    return subprocess.run([sys.executable, "-m", *map(str, cmd)], capture_output=True,
                          text=True, env=env, timeout=timeout)


def _last_json(proc, what: str) -> dict:
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def protocol_cli() -> dict:
    """12c: ``python -m nerve_tpu_torch.recovery_protocol`` at 1 epoch, 48/16
    samples, its defaults otherwise."""
    t0 = time.perf_counter()
    out = _last_json(_run(["nerve_tpu_torch.recovery_protocol", "--epochs", "1",
                           "--train-samples", "48", "--eval-samples", "16"]),
                     "the recovery protocol CLI")
    out["wall_s"] = time.perf_counter() - t0
    return out


def write_nerve_cl_engine(dev, path: Path) -> None:
    """12d: the seeded bf16 engine's weights (the fusion's projections at
    nerve_cl's 1/c constants) as a nerve_cl state dict under
    ``"model_state_dict"``; the importer must read them back bit-exactly."""
    eng = seeded_engine(dev, seed=5)
    variables = flax_variables(eng.module)
    c = 4 * ENGINE_CONFIG.recovery_base_channels
    for proj in ("spatial_proj", "temporal_proj"):
        variables["params"]["frame_recovery"]["fusion"][proj]["kernel"] = np.full(
            (1, 1, c, c), 1.0 / c, np.float32)
    sd = NerveClExport(variables).engine(ENGINE_CONFIG)
    torch.save({"model_state_dict": sd, "epoch": 0}, path)
    back = import_torch.import_enhancement_engine(import_torch.load_state_dict(str(path)),
                                                  ENGINE_CONFIG)
    from nerve_tpu_torch.models.bridge import _flatten

    for coll in ("params", "batch_stats"):
        want, got = _flatten(variables[coll]), _flatten(back[coll])
        if set(want) != set(got) or not all(np.array_equal(want[k], got[k]) for k in want):
            raise AssertionError(f"the imported {coll} differ from the exported weights")
    print(f"nerve_cl state dict: {len(sd)} entries written, read back bit-exactly "
          f"({sum(v.numel() for v in sd.values())} values)", flush=True)


def torch_checkpoint_cli(tmp: Path) -> dict:
    """12d: ``enhance --torch-checkpoint`` on 3 uint8 1080p frames with a
    mask on the middle one, bf16, flow at half resolution."""
    g = torch.Generator().manual_seed(24)
    np.save(tmp / "in.npy", torch.randint(0, 256, (3, H, W, 3), generator=g,
                                          dtype=torch.uint8).numpy())
    masks = np.zeros((3, 1, H, W), np.float32)
    masks[1, :, MASK_ROWS, MASK_COLS] = 1.0
    np.save(tmp / "m.npy", masks)
    out = _last_json(_run(["nerve_tpu_torch.enhance", tmp / "in.npy", "-o", tmp / "out.npy",
                           "--masks", tmp / "m.npy", "--dtype", "bfloat16",
                           "--sr-flow-downsample", "2", "--torch-checkpoint",
                           tmp / "engine.pth"]), "enhance --torch-checkpoint")
    arr = np.load(tmp / "out.npy", mmap_mode="r")
    out["dtype_ok"] = arr.dtype == np.uint8 and arr.shape == (3, 3, 2 * H, 2 * W)
    return out


def sr_checkpoint_cli(tmp: Path) -> dict:
    """12e: ``train_baseline`` (64/8, 1 epoch at LR 32²) writes a checkpoint;
    ``enhance --sr-checkpoint`` serves 2 frames at 270 × 480 in ``sr_only``
    from it; with 4 RDBs it must exit with the mismatch message."""
    ck = tmp / "ck"
    _last_json(_run(["nerve_tpu_torch.train_baseline", "--epochs", "1", "--train-samples",
                     "16", "--val-samples", "8", "--lr-size", "32", "--batch-size", "8",
                     "--num-features", "64", "--num-blocks", "8", "--checkpoint-dir", ck]),
               "train_baseline")
    g = torch.Generator().manual_seed(25)
    np.save(tmp / "small.npy", torch.randint(0, 256, (2, 270, 480, 3), generator=g,
                                             dtype=torch.uint8).numpy())
    base = ["nerve_tpu_torch.enhance", tmp / "small.npy", "-o", tmp / "sr.npy", "--mode",
            "sr_only", "--sr-checkpoint", ck]
    out = _last_json(_run(base), "enhance --sr-checkpoint")
    bad = _run(base + ["--sr-blocks", "4"])
    out["mismatch_rc"] = bad.returncode
    out["mismatch_message"] = "don't match the engine's SR subtree" in bad.stderr
    out["checkpoint_dir"] = str(ck)
    return out


def check_int8_engine(dev, card: str) -> None:
    """12g and 12f: the int8 engine (``quantize_int8(chains=True)``, phase
    8's calibration crop); its SR net in ``.train()`` on two 64² windows:
    ``conv_chain_int8`` does not launch, ``rdb_int8`` does (8 blocks),
    ``conv_chain`` runs the chain sites' float layers, and the output agrees
    with the plain route's at the int8 limits; then its
    ``streaming_step_pair`` against two ``streaming_step``s at the int8
    limits."""
    import copy

    video, _mask = engine_inputs(dev, 5, H, W, seed=21)
    eng = seeded_engine(dev, seed=0)
    eng.quantize_int8(video[0, :, :, 270:810, 480:1440], chains=True)
    sr = eng.engine.super_resolution
    x = torch.rand((2, 3, 64, 64, 3), generator=torch.Generator().manual_seed(26)).to(dev)
    model = copy.deepcopy(sr).train()
    dispatch.reset_launches()
    out = model(x)
    torch.cuda.synchronize()
    launched = {k: v for k, v in dispatch.launches.items() if v}
    with plain_ops():
        dispatch.reset_launches()
        ref = copy.deepcopy(sr).train()(x)
        plain_launched = sum(dispatch.launches.values())
    d = (out.float() - ref.float()).abs()
    print(f"int8 SR net in .train() (2 x 64^2 windows): launches {launched}; plain route "
          f"{plain_launched}; kernels vs plain max|d| {d.max().item():.3e} (limit "
          f"{INT8_MAX_ABS}), mean {d.mean().item():.3e} (limit {INT8_MEAN_ABS}); output "
          f"requires grad {out.requires_grad}", flush=True)
    if (launched.get("conv_chain_int8", 0) or launched.get("rdb_int8") != 8
            or not launched.get("conv_chain") or plain_launched
            or d.max() > INT8_MAX_ABS or d.mean() > INT8_MEAN_ABS or not out.requires_grad):
        raise AssertionError("the int8 SR net in training mode")
    with torch.inference_mode():
        check_pair_step(sr, api.from_uint8(video), card, (INT8_MAX_ABS, INT8_MEAN_ABS),
                        "int8 engine ")


def check_recovery_step(dev, card: str) -> None:
    """12a: one train step at full width, card against CPU."""
    r = diag_recovery.step_against_cpu(dev)
    over = {k: v for k, v in r["grads"].items() if v["rel_l2"] > RECOVERY_GRAD_L2}
    farther = [k for k, v in over.items() if v["card_vs_f64"] > v["cpu_vs_f64"]]
    w = r["grads"][r["worst_grad"]]
    print(f"recovery step (base 64, window 2, T=5, batch 8, 64^2, float32) card vs CPU: "
          f"loss {r['loss_card']!r} vs {r['loss_cpu']!r}, rel {r['loss_rel']:.3e} (limit "
          f"{RECOVERY_LOSS_REL}); worst gradient {r['worst_grad']} rel L2 {w['rel_l2']:.3e} "
          f"(limit {RECOVERY_GRAD_L2}; card vs float64 {w['card_vs_f64']:.3e}, CPU vs float64 "
          f"{w['cpu_vs_f64']:.3e}); {len(over)} of {len(r['grads'])} gradients over the limit, "
          f"{len(farther)} of them farther from float64 on the card than on the CPU; running "
          f"statistics max|d| {r['stats_rel']:.3e} of max|CPU| at {r['worst_stat']} (limit "
          f"{RECOVERY_STAT_REL}) on {card}", flush=True)
    for k, v in sorted(over.items(), key=lambda kv: -kv[1]["rel_l2"])[:6]:
        print(f"  {k}: rel L2 {v['rel_l2']:.3e}, card vs float64 {v['card_vs_f64']:.3e}, "
              f"CPU vs float64 {v['cpu_vs_f64']:.3e}", flush=True)
    if r["loss_rel"] > RECOVERY_LOSS_REL or farther or r["stats_rel"] > RECOVERY_STAT_REL:
        raise AssertionError("the recovery step on the card differs from the CPU's")


def check_recovery_training(dev, card: str) -> None:
    """12b: 20 steps; ms per step, device ms, peak memory, launches."""
    t = diag_recovery.step_timing(dev)
    losses = t["losses"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"recovery training 20 steps: losses {losses}; mean of the first 5 {first:.5f} -> "
          f"last 5 {last:.5f}; {t['ms_per_step']:.2f} ms/step (median of 10 after 3; min "
          f"{t['ms_min']:.2f}, max {t['ms_max']:.2f}), CUDA events "
          f"{t['event_ms_per_step']:.2f} "
          f"ms/step over 10 chained steps (utils.profiling.timed_chain; the card's pace, "
          f"idle gaps included), peak "
          f"{t['peak_bytes'] / 2**20:.1f} MiB allocated; hand-written kernel launches per "
          f"step {t['launches_per_step']} (the recovery net is plain ATen/cuDNN) on {card}",
          flush=True)
    if not all(math.isfinite(v) for v in losses) or not last < first \
            or t["launches_per_step"] != 0:
        raise AssertionError("the recovery net did not learn, or launched a kernel")


def check_bn_grads(dev, card: str) -> None:
    """12h: the BatchNorm gradients of the training paths against float64."""
    for name, r in diag_recovery.bn_grads_vs_float64(dev).items():
        k, p = r["kernel"], r["plain"]
        print(f"BN gradients {name} ({r['tensors']} tensors) vs float64 plain route: kernel "
              f"route worst rel L2 {k['rel_l2']:.3e} ({k['rel_l2_at']}), max|d| "
              f"{k['max_abs_rel']:.3e} of max|float64| ({k['max_abs_rel_at']}); plain route "
              f"rel L2 {p['rel_l2']:.3e} ({p['rel_l2_at']}), max|d| {p['max_abs_rel']:.3e} "
              f"({p['max_abs_rel_at']}); kernel within 2x of plain: {r['within_2x']} on {card}",
              flush=True)
        if not r["within_2x"]:
            raise AssertionError(f"{name}: the kernel route's BatchNorm gradients are farther "
                                 "from float64 than twice the plain route's")


def run_recovery_phase(dev, card: str) -> None:
    """Phase 12. The CLIs run as subprocesses beside the in-process checks;
    every child is waited for (or killed at its timeout)."""
    import concurrent.futures

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_nerve_cl_engine(dev, tmp / "engine.pth")
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            jobs = {"protocol": pool.submit(protocol_cli),
                    "torch_checkpoint": pool.submit(torch_checkpoint_cli, tmp),
                    "sr_checkpoint": pool.submit(sr_checkpoint_cli, tmp)}
            check_recovery_step(dev, card)
            check_recovery_training(dev, card)
            check_int8_engine(dev, card)
            check_bn_grads(dev, card)
            res = {k: f.result() for k, f in jobs.items()}
        p = res["protocol"]
        beats = all(p["nerve_tpu_torch"][k] > p["zero_fill_baseline"][k]
                    for k in p["zero_fill_baseline"])
        print(f"recovery protocol CLI (1 epoch, 48/16 samples, base 64, 64px): masked PSNR "
              f"{p['nerve_tpu_torch']} vs zero-fill {p['zero_fill_baseline']}; final loss "
              f"{p['final_loss']:.5f}; train {p['nerve_tpu_torch_train_seconds']} s, wall "
              f"{p['wall_s']:.1f} s, device {p['device']}", flush=True)
        t = res["torch_checkpoint"]
        print(f"enhance --torch-checkpoint 3 x 1080p -> 2160p bf16: {t['seconds']} s, launches "
              f"{t['launches']}, output {t['output_shape']} {t['output_dtype']} on {card}",
              flush=True)
        s = res["sr_checkpoint"]
        print(f"enhance --sr-checkpoint (train_baseline 64/8): output {s['output_shape']}, "
              f"launches {s['launches']}; with 4 RDBs exit {s['mismatch_rc']}, mismatch message "
              f"{s['mismatch_message']}", flush=True)
        eng = api.EnhancementEngine(ENGINE_CONFIG.with_mode("sr_only"), seed=3, device=dev)
        enhance.load_sr_checkpoint(eng.engine, s["checkpoint_dir"])
        saved = CheckpointManager(s["checkpoint_dir"]).restore_raw()
        loaded = all(torch.equal(q.cpu(), saved["params"][k])
                     for k, q in eng.engine.super_resolution.named_parameters())
        launches = t["launches"]
        if not beats:
            raise AssertionError("the protocol's masked PSNR does not beat zero-fill")
        if not t["dtype_ok"] or launches.get("rdb") != 24 or not launches.get("correlation") \
                or not launches.get("conv_chain") or t["backend"] != "cuda":
            raise AssertionError(f"enhance --torch-checkpoint: {t}")
        if s["backend"] != "cuda" or not s["mismatch_rc"] or not s["mismatch_message"] \
                or not loaded:
            raise AssertionError(f"enhance --sr-checkpoint: {s}, weights loaded {loaded}")



# --------------------------------------------------------------------------- #
# ABR and MLOps (phase 13): the streaming simulator, the PPO update, the
# training CLI and the drift detector, card against CPU
# --------------------------------------------------------------------------- #
ABR_ITERS = 4


def abr_train_cli(dev, card: str, tmp: Path) -> None:
    """13c: the vectorised training CLI at its defaults for 4 iterations,
    then ``--mode eval`` on its checkpoint."""
    ck = tmp / "abr.npz"
    steps = ABR_ITERS * ABRConfig().buffer_capacity
    t0 = time.perf_counter()
    out = _last_json(_run(["nerve_tpu_torch.train_abr", "--vectorized", "--num-steps", steps,
                           "--checkpoint", ck]), "train_abr --vectorized")
    wall = time.perf_counter() - t0
    fresh, trained = PPOAgent(seed=42, device=dev), PPOAgent(seed=42, device=dev)
    trained.load(str(ck))
    moved = [n for (n, a), b in zip(fresh.network.named_parameters(),
                                    trained.network.parameters()) if not torch.equal(a, b)]
    with contextlib.redirect_stdout(io.StringIO()):
        ev = train_abr.main(["--mode", "eval", "--checkpoint", str(ck)])
    print(f"train_abr --vectorized (16 streams x 128 steps, {out['iters']} iterations): losses "
          f"{out['losses']}; mean step reward {out['mean_step_reward']:.4f}; rollout ms "
          f"{[round(v, 2) for v in out['rollout_ms']]}, update ms "
          f"{[round(v, 2) for v in out['update_ms']]} (host clock to a synchronise; after the "
          f"first: rollout {statistics.median(out['rollout_ms'][1:]):.2f} ms, update "
          f"{statistics.median(out['update_ms'][1:]):.2f} ms, iteration "
          f"{statistics.median([a + b for a, b in zip(out['rollout_ms'][1:], out['update_ms'][1:])]):.2f}"
          f" ms, median); {len(moved)} of 10 parameters moved; wall {wall:.1f} s; eval {ev} on "
          f"{card}", flush=True)
    if (out["iters"] != ABR_ITERS or not all(math.isfinite(v) for v in out["losses"])
            or len(moved) != 10 or not all(math.isfinite(ev[k]) for k in
                                           ("mean_return", "mean_vmaf", "mean_rebuffer"))):
        raise AssertionError(f"train_abr: {out}, moved {moved}, eval {ev}")


def run_abr_phase(dev, card: str) -> None:
    """Phase 13."""
    r = diag_abr.env_against_cpu(dev)
    print(f"ABR env {r['n']} streams x {r['steps']} steps ({r['ends']} stream ends) card vs "
          f"CPU: max|d| of max|CPU| {r['max_rel'][r['worst']]:.3e} at {r['worst']} (limit "
          f"{diag_abr.ENV_LIMIT}), done equal {r['done_equal']}; {r['ms_per_step']:.3f} ms/step "
          f"(CUDA events over the run, median of 3 after 1) on {card}", flush=True)
    if not diag_abr.env_ok(r):
        raise AssertionError(f"the batched env on the card differs from the CPU's: {r}")
    u = diag_abr.update_against_cpu(dev)
    print(f"PPO update ({u['transitions']} transitions, hidden {u['hidden']}, {u['epochs']} "
          f"epochs) card vs CPU: worst parameter change rel L2 {u['worst_change']:.3e} (limit "
          f"{diag_abr.UPDATE_CHANGE_L2}), moments {u['worst_moment']:.3e} (limit "
          f"{diag_abr.MOMENT_L2}), metrics {u['worst_metric']:.3e} (limit "
          f"{diag_abr.METRIC_REL}), count {u['count']}; metrics {u['metrics']}; "
          f"{u['ms_per_update']:.2f} ms/update (median of 5 after 1) on {card}", flush=True)
    if not diag_abr.update_ok(u):
        raise AssertionError(f"the PPO update on the card differs from the CPU's: {u}")
    with tempfile.TemporaryDirectory() as tmp:
        abr_train_cli(dev, card, Path(tmp))
    q = diag_abr.sequential_timing(dev, 256)
    print(f"sequential ABR loop {q['steps']} steps ({q['episodes']} episodes): "
          f"{q['ms_per_select_action']:.3f} ms per select_action (median; mean "
          f"{q['ms_select_action_mean']:.3f}, max {q['ms_select_action_max']:.3f}; host clock, "
          f"one device-to-host copy each), {len(q['losses'])} updates "
          f"{[round(v, 2) for v in q['ms_per_update']]} ms, losses {q['losses']} on {card}",
          flush=True)
    if not q["losses"] or not all(math.isfinite(v) for v in q["losses"]):
        raise AssertionError(f"the sequential loop: {q}")
    d = diag_abr.drift_against_cpu(dev)
    for k in ("none", "strong"):
        print(f"DriftDetector mmd {d['n']} x {d['d']} shift {k}: score {d[k]['score']!r} vs CPU "
              f"{d[k]['score_cpu']!r}, |d| {d[k]['abs_diff']:.3e} (limit {diag_abr.DRIFT_REL} of "
              f"max(score, 0.05)), drift {d[k]['drift']} vs CPU {d[k]['drift_cpu']}", flush=True)
    print(f"DriftDetector mmd detect: {d['ms_per_detect']:.2f} ms (median of 5 after 1) on {card}",
          flush=True)
    if not diag_abr.drift_ok(d):
        raise AssertionError(f"the MMD on the card differs from the CPU's: {d}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile both slices, writing their traces into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("build"):
        lib = _build.build()
        _build.library()
        print(f"built {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "Performance Loss" in line
                    or re.search(r"\b[1-9]\d* bytes spill", line)):
                print(f"  {line.strip()}")
        check_sass(lib)
    with phase("device"):
        dispatch.reset_launches()
        probe.main([])
        launches_probe = dict(dispatch.launches)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        launch_path(dev)
    with phase("kernels"):
        summary = check_kernels(dev)
        check_wide_depthwise(dev)
        check_planar_non_finite(dev)
        print_launch_records(dev)
        print(json.dumps({"conv": measure(dev, reps=5, small=False)}), flush=True)
    g = torch.Generator().manual_seed(1)
    video = [torch.rand((1, H, W, 3), generator=g).to(dev) for _ in range(STEPS + 1)]
    with phase("bf16 slice"):
        bf16_model = seeded_model(dev, seed=0)
        bf16_outs, launches, bf16_ms = run_slice(bf16_model, video, card)
    with phase("int8 slice"):
        int8_model = seeded_model(dev, seed=0, quantized=True, quantized_chains=True)
        launches8, int8_ms = run_int8_slice(int8_model, video, bf16_outs, ("bf16", bf16_ms),
                                            card)
    with phase("diagnostic paths"):
        summary.update(check_diag_kernels(dev))
        launches8pc = run_per_channel_int8_slice(dev, video, bf16_outs, int8_ms, card)
        launches_rdb, launches_d2s = run_diag_paths(dev)
    del bf16_outs
    with phase("lightweight slice"):
        light_model, launches_lw, launches_planar = run_lightweight_slice(dev, video, card)
    with phase("engine"):
        run_engine_phase(dev, card)
    with phase("train"):
        run_train_phase(dev, card, args.profile)
    with phase("continual"):
        launches_meta, f32_rows = run_continual_phase(dev, card)
    with phase("federated"):
        _round, f32_layers = run_federated_phase(dev, card)
    # The float32 family's numbers: the 64 -> 64 layer and the fusion at 1080p.
    for name, r in (("conv_f32", f32_layers["flagship 64->64 1080p"]),
                    ("rdb_lff_f32", f32_rows["fusion 224->64 (1x1080x1920)"])):
        summary[name] = {"max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r.get("cudnn_ms", r.get("library_ms"))}
    with phase("recovery and checkpoints"):
        run_recovery_phase(dev, card)
    with phase("abr and mlops"):
        run_abr_phase(dev, card)
    if args.profile:
        with phase("profile"):
            diag_recovery.profile_step(dev, Path(args.profile))
            profile({"bf16": streamer(bf16_model), "int8": streamer(int8_model),
                     "lightweight": lambda frame: light_model(frame, "packed"),
                     **engine_steppers(dev)},
                    video, Path(args.profile))
    # Each kernel's launches from the run of the path that carries it.
    runs = {"conv_chain_int8": launches8, "rdb_int8": launches8, "quantize_i8": launches8,
            "rdb_lff_i8": launches8,
            "conv_chain_dw3": launches_lw, "planar_chain": launches_planar,
            "rdb_int8_int32_taps": launches8pc, "rdb_taps": launches_rdb,
            "d2s_packed_planar": launches_d2s, "probe": launches_probe,
            "conv_f32": launches_meta, "rdb_lff_f32": launches_meta}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": runs.get(name, launches)[name], **summary[name]}
               for name, (src, rep, _plain) in KERNELS.items()]
    print(f"total {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
