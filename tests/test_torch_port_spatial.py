"""The port's height-sharded inference against the JAX package's, on the CPU.

Four gloo ranks (``nerve_tpu_torch.parallel.launch.run_cases``, spawned
once for the module) against ``nerve_tpu.parallel.spatial`` on four of the
eight virtual CPU devices (``make_mesh(data=1, model=4)``, and (2, 2) for
data × model). A tiny flagship (8 features, 1 RDB, window 1, flow at half
resolution, H = 64, W = 24) and the lightweight model, every weight seeded
(``randomize``: the flow is not zero) and bridged from the flax variables.
float32; each gathered output against JAX's on every row, the frame's edge
bands included, within 1e-5 of max|ref|; the gradient of a loss through the
sharded forward (data × model) against ``jax.grad`` of the same within 1e-4
in relative L2. Also: the sharded forward against the port's own
one-device forward on the interior rows (the same weights with the last
flow layer zero, so the receptive field is the convolutions' 17 rows, at H
= 96 with halo 24), an extended slab of odd height (H = 68: slabs of 17
rows, 33 with the halo, which the half-resolution flow pools and resizes),
the ranks' mesh rules, and an indivisible H raising.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerve_tpu.models import LightweightSuperResolution as JaxLight
from nerve_tpu.models.super_resolution import SuperResolutionNet as JaxSR
from nerve_tpu.parallel import spatial as jspatial
from nerve_tpu.parallel.mesh import make_mesh as jax_mesh
from nerve_tpu_torch.models import lightweight_from_flax, sr_from_flax
from nerve_tpu_torch.models.bridge import params_to_flax
from nerve_tpu_torch.parallel import init_distributed, launch, make_mesh, shard_batch, shard_rows
from nerve_tpu_torch.parallel.spatial import ROW_AXIS
from test_torch_port_models import randomize

CFG = dict(scale_factor=2, num_features=8, num_residual_blocks=1, temporal_window=1,
           flow_downsample=2)
LIGHT = dict(scale_factor=2)
REL = 1e-5
GRAD_L2 = 1e-4
# Each JAX function runs in one jit (un-jitted, shard_map runs op by op for
# minutes); LLVM's optimisations off compile it in less time.
XLA_OPTS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
H, W = 64, 24
R = 2 * 18  # scale · (the zero-flow net's receptive field of 17 rows + 1)
LAYOUTS = ("nhwc", "planar", "packed")


def _cases():
    model4, dm = [1, 1, 4], [2, 1, 2]
    cases = [
        {"name": "sr_h8", "fn": "sr", "mesh": model4, "input": "frames", "halo": 8},
        {"name": "sr_h16", "fn": "sr", "mesh": model4, "input": "frames", "halo": 16},
        {"name": "sr_odd", "fn": "sr", "mesh": model4, "input": "frames_odd", "halo": 8},
        {"name": "sr_zero_flow", "fn": "sr", "model": "sr0", "mesh": model4,
         "input": "frames_tall", "halo": 24},
        {"name": "stream", "fn": "stream", "mesh": model4, "input": "video", "halo": 16},
        {"name": "sr_dm", "fn": "sr", "mesh": dm, "input": "frames2", "halo": 8,
         "data_axis": "data"},
        {"name": "sr_grad", "fn": "sr_grad", "mesh": dm, "input": "frames2", "halo": 8,
         "data_axis": "data", "target": "target2"},
    ]
    return cases + [{"name": f"light_{lay}", "fn": "light", "model": "light", "mesh": model4,
                     "input": "lframe", "halo": 8, "layout": lay} for lay in LAYOUTS]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both sides of every case: (JAX variables, inputs, port results)."""
    rng = np.random.default_rng(0)
    inputs = {
        "frames": rng.random((1, 3, H, W, 3)),
        "frames_odd": rng.random((1, 3, 68, W, 3)),
        "frames_tall": rng.random((1, 3, 96, W, 3)),
        "video": rng.random((1, 4, H, W, 3)),
        "frames2": rng.random((2, 3, H, W, 3)),
        "target2": rng.random((2, 2 * H, 2 * W, 3)),
        "lframe": rng.random((1, H, W, 3)),
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    key = jax.random.PRNGKey(0)
    sr_vars = randomize(jax.jit(JaxSR(**CFG).init)(key, jnp.asarray(inputs["frames"][:, :, :16])),
                        seed=1)
    # The channel attention's one hidden unit alive (its input, a pool of
    # non-negative features, times a positive kernel), so the pool's sum
    # over the ranks carries a gradient.
    att = sr_vars["params"]["temporal_aggregator"]["refine"]["ChannelAttention_0"]["Dense_0"]
    att["kernel"] = np.abs(att["kernel"])
    light_vars = randomize(JaxLight(**LIGHT).init(key, jnp.asarray(inputs["lframe"][:, :16])),
                           seed=2)
    zero_flow = jax.tree_util.tree_map(np.copy, sr_vars)
    for k in ("kernel", "bias"):
        f3 = zero_flow["params"]["motion_estimator"]["flow3"]
        f3[k] = np.zeros_like(f3[k])
    port = {"sr": sr_from_flax(sr_vars, device="cpu", **CFG),
            "sr0": sr_from_flax(zero_flow, device="cpu", **CFG),
            "light": lightweight_from_flax(light_vars, device="cpu", **LIGHT)}
    arrays = {f"x/{k}": v for k, v in inputs.items()}
    for name, m in port.items():
        arrays.update(launch.state_arrays(name, m))
    kinds = {"sr": ("sr", CFG), "sr0": ("sr", CFG), "light": ("lightweight", LIGHT)}
    spec = {"models": {n: {"kind": k, "config": c, "dtype": "float32"}
                       for n, (k, c) in kinds.items()},
            "cases": _cases()}
    spec_dir = launch.write_spec(tmp_path_factory.mktemp("spatial"), spec, arrays)
    launch.spawn(launch.run_cases, 4, "gloo", "cpu", args=(str(spec_dir),), timeout=300)
    results = torch.load(spec_dir / "result.pt")
    return types.SimpleNamespace(sr_vars=sr_vars, light_vars=light_vars, inputs=inputs,
                                 port=port, results=results)


def _close(got, ref, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.max(np.abs(ref))))


def _mesh4():
    return jax_mesh(data=1, model=4)


def _jax(fn, *args):
    return jax.jit(fn, compiler_options=XLA_OPTS)(*args)


@pytest.mark.parametrize("case,halo,inp", [("sr_h8", 8, "frames"), ("sr_h16", 16, "frames"),
                                           ("sr_odd", 8, "frames_odd")])
def test_spatial_sr_matches_jax_every_row(run, case, halo, inp):
    mesh = _mesh4()
    want = _jax(lambda v, x: jspatial.spatial_sr_apply(JaxSR(**CFG), v, x, mesh, halo=halo),
                run.sr_vars, run.inputs[inp])
    _close(run.results[case]["out"], want)


def test_odd_extended_height(run):
    """68 rows over 4 ranks: slabs of 17, 33 rows with the halo of 8."""
    out = run.results["sr_odd"]["out"]
    assert out.shape == (1, 136, 2 * W, 3) and (17 + 2 * 8) % 2 == 1


def test_sharded_equals_one_device_interior(run):
    frames = torch.from_numpy(run.inputs["frames_tall"])
    with torch.inference_mode():
        want = run.port["sr0"](frames)
    got = run.results["sr_zero_flow"]["out"]
    assert got.shape == want.shape == (1, 192, 2 * W, 3)
    _close(got[:, R:-R], want[:, R:-R])
    # The edge bands differ (a zero halo once against padding at every layer).
    assert float((got - want).abs().max()) > 1e-3


def test_flow_is_not_zero(run):
    x = torch.from_numpy(run.inputs["frames"][:, :2].reshape(2, H, W, 3))
    with torch.inference_mode():
        f = run.port["sr"].extract_features(x)
        assert float(run.port["sr"].motion_estimator(f[:1], f[1:]).abs().max()) > 1e-2


def test_spatial_streaming_matches_jax(run):
    mesh = _mesh4()
    want = _jax(lambda v, x: jspatial.spatial_streaming_apply(JaxSR(**CFG), v, x, mesh, halo=16),
                run.sr_vars, run.inputs["video"])
    got = run.results["stream"]["out"]
    assert got.shape == (1, 4, 2 * H, 2 * W, 3)
    _close(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_lightweight_matches_jax(run, layout):
    mesh = _mesh4()
    want = _jax(lambda v, x: jspatial.spatial_lightweight_apply(
        JaxLight(**LIGHT), v, x, mesh, halo=8, output_layout=layout),
        run.light_vars, run.inputs["lframe"])
    got = run.results[f"light_{layout}"]["out"]
    assert got.shape[ROW_AXIS[layout]] == 2 * H
    _close(got, want)


def test_data_model_matches_jax(run):
    mesh = jax_mesh(data=2, model=2)
    want = _jax(lambda v, x: jspatial.spatial_sr_apply(JaxSR(**CFG), v, x, mesh, halo=8,
                                                       data_axis="data"),
                run.sr_vars, run.inputs["frames2"])
    _close(run.results["sr_dm"]["out"], want)


def test_gradient_through_the_sharded_forward(run):
    """Case 4 of the dry run: data × model, a loss through the sharded
    forward, its gradient against ``jax.grad``."""
    mesh = jax_mesh(data=2, model=2)
    frames, target = jnp.asarray(run.inputs["frames2"]), jnp.asarray(run.inputs["target2"])
    model = JaxSR(**CFG)

    def loss(params):
        out = jspatial.spatial_sr_apply(model, {**run.sr_vars, "params": params}, frames, mesh,
                                        halo=8, data_axis="data")
        return jnp.mean(jnp.square(out - target))

    jloss, jgrads = _jax(jax.value_and_grad(loss), run.sr_vars["params"])
    res = run.results["sr_grad"]
    assert abs(float(res["loss"]) - float(jloss)) <= REL * abs(float(jloss))
    got = dict(_flat(params_to_flax(res["grads"])))
    ref = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(got) == set(ref)
    diff = np.concatenate([(got[k] - ref[k]).ravel() for k in ref])
    norm = np.linalg.norm(np.concatenate([ref[k].ravel() for k in ref]))
    assert norm > 0 and np.linalg.norm(diff) <= GRAD_L2 * norm
    # The CBAM pool's sum over the ranks carries a gradient of its own.
    assert np.abs(ref["temporal_aggregator/refine/ChannelAttention_0/Dense_0/kernel"]).max() > 0


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_sharded_run_launches_no_kernel_on_the_cpu(run):
    """CPU tensors take the plain versions on every rank."""
    for res in run.results.values():
        assert res["launches"] == [{}] * 4


def test_indivisible_height_raises(run):
    mesh = types.SimpleNamespace(size=lambda axis: 4, index=lambda axis: 0,
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(torch.zeros(1, 3, 30, 16, 3), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        jspatial.spatial_sr_apply(JaxSR(**CFG), {}, jnp.zeros((1, 3, 30, 16, 3)), _mesh4())


def test_mesh_rules_in_one_rank(tmp_path):
    """The JAX package's arithmetic and errors on a world of one rank, and a
    mesh that leaves ranks out refused; no layout chosen for a caller who
    asked for another (NCCL on the CPU, the card without one)."""
    with pytest.raises(ValueError, match="does not run a mesh on cpu"):
        init_distributed("nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed("nccl", device="cuda")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "client": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(data=2, device="cpu")
        with pytest.raises(ValueError, match="not divisible by client"):
            make_mesh(model=2, device="cpu")
        with pytest.raises(ValueError, match="unknown mesh axis"):
            mesh.size("spatial")
        x = torch.arange(24.0).reshape(4, 1, 6, 1, 1)
        assert torch.equal(shard_batch(x, mesh), x) and torch.equal(shard_rows(x, mesh), x)
    finally:
        dist.destroy_process_group()
