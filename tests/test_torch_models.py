"""The port's models (mmfn_tpu_torch.models) against the JAX package's, on the CPU.

Each JAX module is initialised, its constant-initialised leaves (norm scales
and biases, BN statistics, position embeddings) are randomised so that a
swapped or misplaced parameter shows, and the tree is carried across with
mmfn_tpu_torch.utils.weights. The same numpy inputs go through both sides.
Tolerances: 1e-5 for the fusion transformer, 1e-4 for the other modules,
rtol 1e-4 / atol 2e-3 for whole-model waypoints (an untrained net emits
waypoints of order 1e2-1e3, see tests/test_agent_e2e.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.models import build_model as jax_build_model
from mmfn_tpu.models.decoder import WaypointDecoder
from mmfn_tpu.models.gat import RadarGAT as JaxGAT
from mmfn_tpu.models.gpt import FusionTransformer as JaxFusion
from mmfn_tpu.models.resnet import ResNet as JaxResNet
from mmfn_tpu.models.vectornet import VectornetEncoder as JaxVectornet
from mmfn_tpu.utils.weights import convert_mmfn

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.models import build_model, gpt
from mmfn_tpu_torch.models.decoder import decode_waypoints
from mmfn_tpu_torch.models.gat import RadarGAT
from mmfn_tpu_torch.models.gpt import FusionTransformer
from mmfn_tpu_torch.models.resnet import ResNet
from mmfn_tpu_torch.models.vectornet import VectornetEncoder
from mmfn_tpu_torch.utils import weights as tw

HI = jax.lax.Precision.HIGHEST
_CONST_LEAVES = ("scale", "bias", "pos_emb")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _randomise(tree, rng, stats=False):
    """Copy of a flax tree (numpy leaves) with constant-initialised leaves
    made random: BN mean/var in ``stats``, norm scales/biases and position
    embeddings in params."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomise(v, rng, stats)
            continue
        v = np.array(v, dtype=np.float32)
        if stats and k == "mean":
            v = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
        elif stats and k == "var":
            v = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif not stats and k in _CONST_LEAVES:
            v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        out[k] = v
    return out


def _variables(module, *args, seed=0):
    variables = module.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(seed + 1)}, *args)
    rng = np.random.default_rng(seed)
    out = {"params": _randomise(variables["params"], rng)}
    if "batch_stats" in variables:
        out["batch_stats"] = _randomise(variables["batch_stats"], rng, stats=True)
    return out


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stage_sizes,in_ch", [((2, 2, 2, 2), 2), ((3, 4, 6, 3), 3)])
def test_resnet_matches_jax(stage_sizes, in_ch):
    x = np.random.default_rng(1).normal(size=(2, 64, 64, in_ch)).astype(np.float32)
    jmodel = JaxResNet(stage_sizes=stage_sizes, precision=HI)
    variables = _variables(jmodel, jnp.asarray(x), False)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), False))
    port = ResNet(stage_sizes, in_ch).eval()
    port.load_state_dict(tw.resnet_from_flax(variables["params"], variables["batch_stats"],
                                             stage_sizes))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [3, 4])
def test_fusion_transformer_pallas_matches_jax(groups):
    kw = dict(n_embd=64, n_head=4, block_exp=4, n_layer=2, n_groups=groups)
    rng = np.random.default_rng(groups)
    grids = [rng.normal(size=(2, 8, 8, 64)).astype(np.float32) for _ in range(groups)]
    vel = np.abs(rng.normal(size=(2,))).astype(np.float32) * 3
    jmodel = JaxFusion(attn_impl="pallas", precision=HI, **kw)
    jgrids = [jnp.asarray(g) for g in grids]
    variables = _variables(jmodel, jgrids, jnp.asarray(vel), False)
    want = jmodel.apply(variables, jgrids, jnp.asarray(vel), False)
    port = FusionTransformer(attn_impl="pallas", **kw).eval()
    port.load_state_dict(tw.fusion_transformer_from_flax(variables["params"], 2))
    with torch.no_grad():
        got = port([torch.from_numpy(g).permute(0, 3, 1, 2) for g in grids],
                   torch.from_numpy(vel))
    assert len(got) == groups
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_fusion_transformer_training_takes_the_plain_path(monkeypatch):
    """attn_impl='pallas' launches the fused kernel only in eval mode: the
    kernel has no backward, so training must run (and differentiate) the
    plain path."""
    calls = []
    real = gpt.fused_attention
    monkeypatch.setattr(gpt, "fused_attention", lambda *a: calls.append(1) or real(*a))
    kw = dict(n_embd=32, n_head=4, block_exp=4, n_layer=2, n_groups=3,
              embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    model = FusionTransformer(attn_impl="pallas", **kw)
    g = torch.Generator().manual_seed(0)
    grids = [torch.randn(2, 32, 8, 8, generator=g, requires_grad=True) for _ in range(3)]
    vel = torch.rand(2, generator=g)
    out_train = model.train()(grids, vel)
    assert not calls
    sum(o.square().sum() for o in out_train).backward()
    assert all(torch.isfinite(x.grad).all() for x in grids)
    with torch.no_grad():
        out_eval = model.eval()(grids, vel)
    assert len(calls) == 2                       # one launch per block
    for a, b in zip(out_train, out_eval):
        torch.testing.assert_close(a.detach(), b, rtol=1e-5, atol=1e-5)


def test_radar_gat_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 81, 5)).astype(np.float32)
    adj = rng.normal(size=(2, 81, 81)).astype(np.float32)
    jmodel = JaxGAT(dropout=0.0, precision=HI)
    variables = _variables(jmodel, jnp.asarray(x), jnp.asarray(adj), False)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(adj), False))
    port = RadarGAT(dropout=0.0).eval()
    port.load_state_dict(tw.radar_gat_from_flax(variables["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(adj))
    assert tuple(got.shape) == (2, 512, 8, 8)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_vectornet_matches_jax():
    rng = np.random.default_rng(4)
    lanes = (rng.normal(size=(2, 8, 10, 5)) * 5).astype(np.float32)
    lane_num = np.array([3, 8], np.int32)
    lanes[0, 3:] = 0
    jmodel = JaxVectornet(precision=HI)
    variables = _variables(jmodel, jnp.asarray(lanes), jnp.asarray(lane_num), False)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(lanes), jnp.asarray(lane_num), False))
    port = VectornetEncoder().eval()
    port.load_state_dict(tw.vectornet_from_flax(variables["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(lanes), torch.from_numpy(lane_num))
    assert tuple(got.shape) == (2, 64, 64, 64)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("input_mode", ["add", "cat"])
def test_waypoint_decoder_matches_jax(input_mode):
    """'add' is MMFN's GRU input (x + target point); 'cat' is AIM's."""
    rng = np.random.default_rng(6)
    z = rng.normal(size=(3, 64)).astype(np.float32)
    tp = (rng.normal(size=(3, 2)) * 5).astype(np.float32)
    jmodel = WaypointDecoder(precision=HI, input_mode=input_mode)
    variables = _variables(jmodel, jnp.asarray(z), jnp.asarray(tp))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(z), jnp.asarray(tp)))
    p = variables["params"]
    cell, output = nn.GRUCell(2 if input_mode == "add" else 4, 64), nn.Linear(64, 2)
    cell.load_state_dict(tw.gru_from_flax(p["decoder"]))
    output.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        p["output"]["kernel"].T)), "bias": torch.from_numpy(p["output"]["bias"])})
    with torch.no_grad():
        got = decode_waypoints(cell, output, torch.from_numpy(z), torch.from_numpy(tp),
                               input_mode=input_mode).numpy()
    assert got.shape == (3, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# Whole models: JAX init -> from_flax_variables -> port
# --------------------------------------------------------------------------- #

def _inputs(rng, b, res, max_lanes):
    lanes = (rng.normal(size=(b, max_lanes, 10, 5)) * 5).astype(np.float32)
    lane_num = rng.integers(1, max_lanes + 1, size=(b,)).astype(np.int32)
    lane_num[-1] = max_lanes
    for i, n in enumerate(lane_num):
        lanes[i, n:] = 0
    radar = rng.normal(size=(b, 81, 5)).astype(np.float32)
    return dict(
        image=rng.integers(0, 256, size=(b, res, res, 3)).astype(np.float32),
        lidar_bev=rng.integers(0, 6, size=(b, 256, 256, 2)).astype(np.float32) / 5,
        map_img=rng.integers(0, 256, size=(b, res, res, 3)).astype(np.float32),
        lanes=lanes, lane_num=lane_num, radar=radar,
        radar_adj=(radar[:, None, :, 1] - radar[:, :, None, 1]).astype(np.float32),
        target_point=(rng.normal(size=(b, 2)) * 5).astype(np.float32),
        velocity=(np.abs(rng.normal(size=(b,))) * 3).astype(np.float32))


def _model_pair(variant, n_layer, res, max_lanes, attn_impl, seed=0):
    """(JAX model, randomised JAX variables, port model, inputs) on one set
    of weights."""
    kw = dict(n_layer=n_layer, max_lanes=max_lanes, attn_impl=attn_impl)
    jmodel = jax_build_model(JaxConfig(matmul_precision="highest", **kw), variant)
    data = _inputs(np.random.default_rng(seed), 2, res, max_lanes)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    init = jax.jit(jmodel.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jbatch, False)
    rng = np.random.default_rng(seed + 2)
    variables = {"params": _randomise(init["params"], rng),
                 "batch_stats": _randomise(init["batch_stats"], rng, stats=True)}
    port = build_model(GlobalConfig(**kw), variant, device="cpu")
    port.load_state_dict(tw.from_flax_variables(variables, variant, n_layer), strict=True)
    return jmodel, variables, port, data


def _assert_waypoints_match(jmodel, variables, port, data):
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    want = np.asarray(jax.jit(jmodel.apply, static_argnums=(2,))(variables, jbatch, False))
    with torch.no_grad():
        got = port(Batch(**{k: torch.from_numpy(v) for k, v in data.items()})).numpy()
    assert got.shape == want.shape == (data["image"].shape[0], 4, 2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


VARIANT_CASES = [("img", "xla"), ("vec", "xla"), ("rad", "pallas")]


@pytest.fixture(scope="module", params=VARIANT_CASES, ids=[v for v, _ in VARIANT_CASES])
def small_pair(request):
    variant, attn_impl = request.param
    return (variant,) + _model_pair(variant, n_layer=1, res=64, max_lanes=6,
                                    attn_impl=attn_impl)


def test_mmfn_waypoints_match_jax(small_pair):
    _, jmodel, variables, port, data = small_pair
    _assert_waypoints_match(jmodel, variables, port, data)


def test_from_flax_variables_round_trips_through_convert_mmfn(small_pair):
    """convert_mmfn(port.state_dict()) reproduces the JAX tree exactly. For
    vec and rad the port owns no map stem/layer1, but convert_mmfn reads
    those keys unconditionally; the reference checkpoint carries them, so
    they are supplied here as zeros and their converted subtrees (which the
    JAX tree does not have) are set aside."""
    variant, _, variables, port, _ = small_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if variant != "img":
        full = build_model(GlobalConfig(n_layer=1, max_lanes=6), "img", device="cpu").state_dict()
        for k, v in full.items():
            if k.startswith(tw._MAP_STEM):
                sd[k] = np.zeros(tuple(v.shape), v.numpy().dtype)
    back = convert_mmfn(sd, variant, n_layer=1)
    if variant != "img":
        for coll in ("params", "batch_stats"):
            m = back[coll]["encoder"]["img_map_encoder"]
            for name in ["conv1", "bn1"] + [f"layer1_{j}" for j in range(3)]:
                m.pop(name, None)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_got) == set(flat_want)
    for path, want in flat_want.items():
        got = flat_got[path]
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_load_reference_state_dict_tolerates_the_unused_map_stem(small_pair):
    variant, _, _, port, _ = small_pair
    sd = {f"module.{k}": v.clone() for k, v in port.state_dict().items()}
    full = build_model(GlobalConfig(n_layer=1, max_lanes=6), "img", device="cpu").state_dict()
    for k, v in full.items():
        if k.startswith(tw._MAP_STEM):
            sd.setdefault(f"module.{k}", v)
    fresh = build_model(GlobalConfig(n_layer=1, max_lanes=6), variant,
                        torch.Generator().manual_seed(9), device="cpu")
    tw.load_reference_state_dict(fresh, sd)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        tw.load_reference_state_dict(fresh, {**sd, "encoder.bogus.weight": torch.zeros(1)})


def test_build_model_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    """build_model without a device raises where there is no CUDA device; on
    request it builds on the CPU, with the same weights from one seed."""
    cfg = GlobalConfig(n_layer=1, max_lanes=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, "vec")
    a = build_model(cfg, "vec", torch.Generator().manual_seed(3), device="cpu")
    b = build_model(cfg, "vec", torch.Generator().manual_seed(3), device=torch.device("cpu"))
    assert not a.training
    assert all(p.device.type == "cpu" for p in a.state_dict().values())
    for key, value in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[key], value, rtol=0, atol=0)


@pytest.mark.slow
def test_full_width_rad_matches_jax():
    """Full-width MMFN-rad, the served configuration: n_layer=8, 256 px,
    64 lanes, fused attention on both sides."""
    _assert_waypoints_match(*_model_pair("rad", n_layer=8, res=256, max_lanes=64,
                                         attn_impl="pallas"))
