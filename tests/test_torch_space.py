"""The port's space axis on two gloo ranks against the JAX package on a
2-device ``space`` mesh of the conftest's CPU devices.

The two ranks run once for the module (``parallel.launch`` of
``srcgan_tpu_torch.parallel.axes_check``: the workers import the port
alone), from the seeds of the models built here, whose weights cross to
JAX through ``interop``.  The cases: ``make_spatial_infer`` of ESPCN x2 and
RDDBNet x4 (atol 2e-5, rtol 1e-4); the space-sharded predictor and its
tiled form on the JAX package's three odd scenes (one of them leaving a
rank empty), within 1 LSB of JAX's sharded predictors and of the port's
unsharded ones; and, in float64 against one process, the group and batch
norms over strips of 48 / 16 rows and of 64 / 0 rows, the ResDeconv's
forward and backward on ragged strips, and the halo units of the fused
paths.  The test of the strip plan needs no ranks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jmodels
from srcgan_tpu import parallel as jparallel
from srcgan_tpu import serving as jserving
from srcgan_tpu_torch import interop
from srcgan_tpu_torch.parallel import axes_check, spatial
from srcgan_tpu_torch.serving import CascadePredictor, TiledPredictor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def problem():
    return axes_check.make_problem()


@pytest.fixture(scope="module")
def ranks(problem):
    return axes_check.run_ranks(problem, 2, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh((2,), ("space",))


def jparams(name):
    return jax.tree_util.tree_map(jnp.asarray, interop.jax_tree_from_module(
        axes_check.build(name))[0])


@pytest.mark.parametrize("name,jax_model", [("espcn", lambda: jmodels.ESPCN(1, 3, 2)),
                                            ("rddb", lambda: jmodels.RDDBNet(1, 1, 4, nf=16,
                                                                             nb=1))])
def test_spatial_infer_matches_jax(ranks, problem, jmesh, name, jax_model):
    x = jnp.asarray(problem[f"sp_{name}"])
    want = jparallel.make_spatial_infer(jax_model(), jmesh)(jparams(name), x)
    np.testing.assert_allclose(ranks[f"sp/{name}"], np.asarray(want), atol=2e-5, rtol=1e-4)


def _lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.fixture(scope="module")
def cascades(jmesh):
    """(the JAX sharded predictor, its tiled form, the port's unsharded pair)."""
    sr, c = jmodels.ESPCN(1, 1, 2), jmodels.ResDeconv(1, 3)
    pa, pb = jparams("cas_sr"), jparams("cas_c")
    tiled = dict(tile=32, overlap=8, max_batch=2)
    psr, pc = axes_check.build("cas_sr"), axes_check.build("cas_c")
    return (jserving.SpatialShardedPredictor(sr, pa, c, pb, up=2, mesh=jmesh),
            jserving.SpatialShardedTiledPredictor(sr, pa, c, pb, up=2, mesh=jmesh, **tiled),
            CascadePredictor(psr, pc, 2, device="cpu"),
            TiledPredictor(psr, pc, 2, device="cpu", **tiled))


def test_sharded_predictor_within_one_lsb(ranks, problem, cascades):
    jpred, _, pred, _ = cascades
    got = ranks["pred/u8"]
    assert got.shape == (1, 128, 32, 3)
    assert _lsb(got, np.asarray(jpred.predict(problem["pred_u8"]))) <= 1
    assert _lsb(got, pred.predict(problem["pred_u8"])) <= 1


def test_sharded_predictor_reload_and_ensemble(ranks, problem):
    """A reload on rank 0 reaches the follower (the reloaded pair's
    unsharded answer within 1 LSB), and the self-ensembled batch crosses
    the strips as fp32 gray copies (within 1 LSB of the unsharded one)."""
    x = problem["pred_u8"]
    again = CascadePredictor(*axes_check.reloaded_pair(), 2, device="cpu")
    assert _lsb(ranks["pred/reloaded"], again.predict(x)) <= 1
    ens = CascadePredictor(axes_check.build("cas_sr"), axes_check.build("cas_c"), 2,
                           device="cpu", self_ensemble=True)
    assert _lsb(ranks["pred/ensemble"], ens.predict(x)) <= 1


@pytest.mark.parametrize("shape", axes_check.SCENES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_tiled_odd_scenes(ranks, problem, cascades, shape):
    """Sub-tile scenes at their own shape through the strips: H not
    divisible by the mesh, H below the alignment (rank 1 empty), H just
    above the tile core."""
    _, jtiled, _, tiled = cascades
    key = axes_check.scene_key(shape)
    got = ranks[f"tiled/{key}"]
    assert _lsb(got, np.asarray(jtiled.predict_scene(problem[key]))) <= 1
    assert _lsb(got, tiled.predict_scene(problem[key])) <= 1
    heights = ranks[f"tiled/plan/{key}"]
    assert heights.sum() == shape[0] and (heights[0] > 0)
    if shape[0] < 8:
        assert heights.tolist() == [shape[0], 0]


@pytest.mark.parametrize("layer", ["gn", "bn"])
@pytest.mark.parametrize("heights", ["48_16", "64_0"])
def test_norm_moments_over_uneven_and_empty_strips(ranks, layer, heights):
    """Output, input gradient and scale gradient of the strips, float64,
    against one process on the whole image."""
    out, gx, gw = ranks[f"norm/{layer}/{heights}"]
    assert out <= 1e-12 and gx <= 1e-10 and gw <= 1e-8, (out, gx, gw)


def test_ragged_strips_forward_and_backward(ranks):
    """ResDeconv on 46 rows (strips of 16 and 30): the strided convs' ceil
    arithmetic gives the whole image's 48 output rows, and the halo
    exchange's backward the whole image's gradients (float64)."""
    y, gx, gp, rows, rows_ref = ranks["ragged/resdeconv"]
    assert rows == rows_ref == 48
    assert max(y, gx, gp) <= 1e-12, (y, gx, gp)


def test_halo_units_are_exact(ranks):
    """A 5-conv chain on a strip plus 5 rows each side, and the x4 tail on
    a strip extended to a multiple of 8 rows by the neighbour's rows, both
    cropped; x2 bilinear (one halo row, the edge rows repeated at the true
    edges) and nearest upsampling: bit-equal to the whole image's, the
    bilinear one to float64's rounding."""
    chain, tail, bilinear, nearest = ranks["units"].tolist()
    assert chain == tail == nearest == 0.0 and bilinear <= 1e-12


@pytest.mark.parametrize("h,ranks_,align,rows,want", [
    (64, 2, 8, 8, (32, 32)), (23, 2, 8, 8, (8, 15)), (7, 2, 8, 8, (7, 0)),
    (37, 4, 8, 16, (16, 21, 0, 0)), (512, 4, 4, 8, (128, 128, 128, 128)),
    (50, 3, 4, 8, (16, 16, 18))])
def test_strip_plan(h, ranks_, align, rows, want):
    plan = spatial.plan_strips(h, ranks_, align, rows)
    assert plan.heights == want
    assert all(s % align == 0 for s, n in zip(plan.starts, plan.heights) if n)


# -- the four-card scene cell's reference and driver (portbench), at small sizes ---------

def _scene_config(precision="fp32"):
    """srcgan_g2rgb_x4 with a narrow RDDBNet (the colorizer as published)."""
    from portbench import harness

    cfg = harness.load_json(harness.BENCH / "configs" / "srcgan_g2rgb_x4.json")
    cfg["sr_model"].update(nf=8, nb=1, gc=4)
    cfg["precision"] = precision
    return cfg


@pytest.mark.parametrize("heights", [(8, 8, 16), (16, 4, 12)])
def test_blockwise_group_norm_matches_float64(heights):
    """The scene reference's GroupNorm over row blocks (float64 sums in two
    passes) against the whole image's float64 GroupNorm."""
    from portbench.reference import scene

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, sum(heights), 12, generator=gen) * 3 + 1
    w, b = torch.rand(64, generator=gen), torch.randn(64, generator=gen)
    net = scene.Scene({"gn.weight": w, "gn.bias": b})
    got = torch.cat(net.group_norm(list(x.split(list(heights), 2)), "gn", 32), 2)
    want = torch.nn.functional.group_norm(x.double(), 32, w.double(), b.double(), 1e-5)
    assert float((got.double() - want).abs().max()) <= 2e-6


def test_blockwise_scene_reference_matches_the_whole_image():
    """The scene reference in blocks of 16 input rows (64 at the colorizer,
    4 at its stride-16 layers: the halos of every layer cross blocks) within
    1 LSB of ``reference.cascade.serve_u8`` on the whole scene."""
    from portbench import cascade as cs
    from portbench.reference import cascade as ref
    from portbench.reference import scene

    cfg = _scene_config()
    gen = torch.Generator().manual_seed(3)
    p_sr = cs._draw(ref.rddbnet_specs(cfg["sr_model"]), gen, "cpu")
    p_c = cs._draw(ref.resdeconv_specs(cfg["c_model"]), gen, "cpu")
    p_c["pred.weight"].mul_(0.03)
    x = torch.randint(0, 256, (80, 48, 1), generator=gen, dtype=torch.uint8)
    whole = ref.serve_u8(p_sr, p_c, cfg, x[None])[0].numpy()
    blocks = scene.serve_u8(p_sr, p_c, cfg, x.numpy(), [torch.device("cpu")], rows=16)
    d = np.abs(whole.astype(int) - blocks.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("variant", ["program", "halo_short"])
def test_space_driver_numbers(variant):
    """The scene cell's driver on two gloo ranks (this process leads, one
    follower spawned) at a 64x64 scene, fp32: both numbers 0 for the
    program; with one halo row short, values off at the seam."""
    from portbench import harness

    traffic = {"driver": "space", "ranks": 2, "side": 64, "pool": 2, "warmup": 1,
               "trace_s": 1.0, "block": 64, "seam_rows": 8}
    cell = harness.Cell("x4_scene_space4", _scene_config(), traffic, {}, 1835644354, 0.5, False,
                        torch.device("cpu"), variant)
    out = harness.run_driver(cell)
    numbers = out.numbers
    assert out.attempted >= 1 and out.metrics["scene_mp_s"] > 0
    if variant == "program":
        assert numbers == {"worst_answer_share_off": 0.0, "seam_share_off": 0.0}
    else:
        assert numbers["seam_share_off"] > 0.1
        assert numbers["seam_share_off"] > numbers["worst_answer_share_off"] / 2
