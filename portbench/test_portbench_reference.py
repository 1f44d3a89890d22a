"""The plain reference held against the port on the CPU, at small sizes, on
weights made from a seed: the cascade, the tile plan and one train step."""

import numpy as np
import pytest
import torch

from portbench import cascade as cs
from portbench import harness
from portbench.drivers import train as train_driver
from portbench.reference import cascade as ref
from portbench.reference import tiles
from portbench.reference import train as ref_train

def cell(workload: str, **traffic):
    c, _, _ = harness.cell_from_files(workload, 2_147_483_700, 1.0, False)
    c.traffic.update(traffic)
    c.device = torch.device("cpu")
    return c

@pytest.fixture(scope="module")
def x4():
    c = cell("x4_stream_b8")
    return c, *cs.make_weights(c)

def test_reference_names_load_strictly_into_the_port(x4):
    c, p_sr, p_c = x4
    sr, col = cs.program_models(c, p_sr, p_c)     # load_state_dict(strict=True)
    assert sum(p.numel() for p in sr.parameters()) == sum(v.numel() for v in p_sr.values())
    assert sum(p.numel() for p in col.parameters()) == sum(v.numel() for v in p_c.values())

@pytest.mark.parametrize("path,value", [("sr_model.name", "EDSR"), ("c_model.name", "UNet"),
                                        ("c_model.norm", "BN"), ("c_model.groups", 16)])
def test_a_configuration_the_benchmark_does_not_build_is_refused(path, value):
    c = cell("x4_stream_b8")
    group, key = path.split(".")
    c.config[group] = {**c.config[group], key: value}
    with pytest.raises(ValueError, match=key if key != "groups" else "GroupNorm"):
        p_sr, p_c = cs.make_weights(c)
        cs.program_models(c, p_sr, p_c)


def test_cascade_fp32_matches_the_port(x4):
    from srcgan_tpu_torch.serving import CascadePredictor

    c, p_sr, p_c = x4
    pred = CascadePredictor(*cs.program_models(c, p_sr, p_c), 4, device="cpu")
    x = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    got = pred.predict(x).astype(int)
    want = ref.serve_u8(p_sr, p_c, c.config, torch.from_numpy(x)).numpy().astype(int)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert np.abs(got - want).max() <= 1
    assert len(np.unique(want)) > 10            # pred_scale keeps the answer off the clip

def test_tile_plan_is_the_ports():
    from srcgan_tpu_torch.serving import TiledPredictor

    for n, t, ov in ((512, 256, 32), (1000, 256, 32), (1536, 256, 32), (48, 32, 8)):
        assert tiles.axis_windows(n, t, ov) == TiledPredictor._axis_windows(n, t, ov)

def test_stitched_scene_matches_the_port(x4):
    from srcgan_tpu_torch.serving import TiledPredictor

    c, p_sr, p_c = x4
    pred = TiledPredictor(*cs.program_models(c, p_sr, p_c), 4, tile=32, overlap=8, max_batch=4,
                          device="cpu")
    scene = np.random.default_rng(1).integers(0, 256, (48, 80, 1), dtype=np.uint8)
    got = pred.predict_scene(scene).astype(int)
    windows = tiles.plan(48, 80, 32, 8)
    outs = cs.reference_u8(c, p_sr, p_c, [tiles.crops(scene, windows, 32)])[0]
    want = tiles.stitch(outs, windows, 48, 80, 4).astype(int)
    assert got.shape == want.shape == (192, 320, 3)
    assert np.abs(got - want).max() <= 1

def test_train_steps_match_the_port():
    from srcgan_tpu_torch.train.cas import CasTrainer

    c = cell("x2_train_b32", batch=2, side=32, pool=2)
    p_sr, p_c = cs.make_weights(c)
    data = train_driver.batches(c)
    trainer = CasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=2, lr=1e-4,
                         fused_input=True, device="cpu")
    state = trainer.init(0)
    state.sr.model.load_state_dict(p_sr)
    state.c.model.load_state_dict(p_c)
    losses = []
    for i in range(2):
        state, met = trainer.train_step_u8(state, data[i], data[i], 1e-4)
        losses.append((float(met["loss_SR"]), float(met["loss_C"])))
        if i == 0:
            first = {role: {k: ts.opt.state[p]["exp_avg"] / 0.1
                            for k, p in ts.model.named_parameters()}
                     for role, ts in (("sr", state.sr), ("c", state.c))}
    want_losses, want_first, want_after, _ = ref_train.run(p_sr, p_c, c.config,
                                                           [data[0], data[1]], 1e-4)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for role, ts in (("sr", state.sr), ("c", state.c)):
        for k, p in ts.model.named_parameters():
            g, w = first[role][k], want_first[role][k]
            assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-12, k
            d = p.detach() - (p_sr if role == "sr" else p_c)[k]
            dw = want_after[role][k] - (p_sr if role == "sr" else p_c)[k]
            # Adam's steps are about +-lr an element; a flipped sign moves one by 2 lr
            assert float((d - dw).abs().max()) <= 2.01e-4, k

def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    for y in (ref.FP8.act(x), ref.FP8.weight(x)):
        # three mantissa bits: half a step is at most 2^-4 of the value (above the subnormals)
        assert bool(((y - x).abs() <= 2 ** -4 * x.abs() + 1e-3).all())
        assert len(torch.unique(y)) < 300
    w = x.clone().requires_grad_(True)
    ref.FP8.weight(w).sum().backward()         # a weight's gradient straight through
    assert torch.equal(w.grad, torch.ones_like(w))
    a = x.clone().requires_grad_(True)
    g = torch.linspace(-1, 1, 1001)
    ref.FP8.act(a).backward(g)                 # an input's gradient in e5m2: two mantissa bits
    assert not torch.equal(a.grad, g)
    assert bool(((a.grad - g).abs() <= 2 ** -3 * g.abs() + 1e-4).all())
    assert ref.FP32.act(x) is x and ref.FP32.weight(x) is x
