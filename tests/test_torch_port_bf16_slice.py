"""The port's streaming SR slice in bfloat16 against the JAX package.

The narrow model of ``tests/test_torch_port_slice.py`` (16 features, 2 RDBs,
temporal window 1, flow at half resolution, every parameter and BatchNorm
statistic seeded non-zero, so the flow is not zero and the warp samples
between pixels), here in bfloat16 on a 16 × 24 frame (H < 128: the JAX
warp takes its unchunked path, which keeps the row offset exact). The JAX
step is compiled with ``xla_allow_excess_precision`` off, so that XLA
rounds each bfloat16 intermediate where its source does. Limits on the
[0, 1] packed output: max|Δ| ≤ 2e-2 and mean|Δ| ≤ 5e-4, the limits of
``chip_smoke.py``'s slice; bfloat16 rounds at different sums in the two
frameworks' convolutions, and one-ulp flips propagate through the RDBs.
Measured max|Δ| 3.906e-03 (one bfloat16 step near 1) and mean|Δ|
6.7e-05-7.5e-05 over the three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerve_tpu.models import streaming as jstream
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu_torch.models import sr_from_flax, streaming_prime, streaming_step
from test_torch_port_models import randomize

CFG = dict(scale_factor=2, num_features=16, num_residual_blocks=2,
           temporal_window=1, flow_downsample=2)
MAX_ABS, MEAN_ABS = 2e-2, 5e-4


@pytest.fixture(scope="module")
def bf16_models():
    video = np.random.default_rng(0).random((1, 4, 16, 24, 3)).astype(np.float32)
    jmodel = JaxSR(**CFG, dtype=jnp.bfloat16)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(video[:, :3]))
    variables = randomize(init, seed=1)
    tmodel = sr_from_flax(variables, device="cpu", dtype=torch.bfloat16, **CFG)
    return jmodel, variables, tmodel, video


def test_bf16_flow_is_not_zero(bf16_models):
    _jm, _v, tmodel, video = bf16_models
    x = torch.from_numpy(video[:, :2].reshape(2, 16, 24, 3))
    with torch.inference_mode():
        feats = tmodel.extract_features(x)
        flow = tmodel.motion_estimator(feats[:1], feats[1:])
    assert flow.dtype == torch.bfloat16
    assert float(flow.abs().max()) > 1e-2
    assert bool((flow.float() != flow.float().round()).any())  # samples between pixels


def test_bf16_streaming_step_matches_jax(bf16_models):
    jmodel, variables, tmodel, video = bf16_models
    jstep = jax.jit(lambda c, x: jstream.streaming_step(jmodel, variables, c, x, "packed"),
                    compiler_options={"xla_allow_excess_precision": False})
    jprime = jax.jit(lambda x: jstream.streaming_prime(jmodel, variables, x),
                     compiler_options={"xla_allow_excess_precision": False})
    jcarry = jprime(jnp.asarray(video[:, 0]))
    with torch.inference_mode():
        tcarry = streaming_prime(tmodel, torch.from_numpy(video[:, 0]))
        for t in (1, 2, 3):
            jcarry, ref = jstep(jcarry, jnp.asarray(video[:, t]))
            tcarry, got = streaming_step(tmodel, tcarry, torch.from_numpy(video[:, t]), "packed")
            ref = np.asarray(ref.astype(jnp.float32))
            got = got.float().numpy()
            assert got.shape == ref.shape == (1, 32, 48 * 3)
            assert 0.0 <= got.min() and got.max() <= 1.0
            diff = np.abs(got - ref)
            assert diff.max() <= MAX_ABS and diff.mean() <= MEAN_ABS, (t, diff.max(), diff.mean())
