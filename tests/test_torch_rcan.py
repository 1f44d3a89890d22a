"""RCAN as the cascade's SR stage: the port's module against the benchmark's
plain float32 reference (``portbench/reference/rcan.py``) on seeded weights,
``models.create("RCAN", 1, 1, 4)`` at the published widths served by
``CascadePredictor``, and the space-sharded predictors' refusal of its
channel attention, whose strips would each take their own mean."""
import numpy as np
import pytest
import torch

from portbench import cascade as bench_cascade
from portbench import zoo
from portbench.reference import cascade as ref
from portbench.reference import rcan as rcan_ref
from srcgan_tpu_torch import models
from srcgan_tpu_torch.models import edsr_zoo
from srcgan_tpu_torch.serving import (CascadePredictor, SpatialShardedPredictor,
                                      SpatialShardedTiledPredictor)

TINY = dict(n_resgroups=2, n_resblocks=2, n_feats=16, reduction=4)


def _weights(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = bench_cascade._draw(rcan_ref.specs(cfg), gen, "cpu")
    p.update(rcan_ref.constants(cfg))
    return p


@pytest.mark.parametrize("form,colors", [("cascade", 1), ("cascade", 3), ("args", 3)])
def test_rcan_matches_the_reference(form, colors):
    """fp32, seeded weights scaled as the benchmark scales them (the
    attention gates spread, the trunk bounded), within 1e-5."""
    cfg = dict(in_ch=colors, ou_ch=colors, up=4, **TINY)
    if form == "cascade":
        net = models.create("RCAN", colors, colors, 4, **TINY)
    else:
        net = models.RCAN(edsr_zoo.args_namespace(scale=[4], rgb_range=1, n_colors=colors,
                                                  **TINY))
    p = _weights(cfg)
    zoo.scale_weights(p, {"pred.weight": torch.ones(1)},
                      {"sr_model": cfg, "rcab_scale": 0.2, "group_scale": 0.2,
                       "ca_up_scale": 4.0, "sr_out_scale": 0.05})
    net.load_state_dict(p, strict=True)
    x = torch.rand(2, colors, 12, 10, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = net(x)
        want = rcan_ref.rcan(p, x, cfg)
    assert got.shape == (2, colors, 48, 40)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_gray_mean_is_the_luma_of_the_rgb_mean():
    net = models.create("RCAN", 1, 1, 2, **TINY)
    assert net.sub_mean.bias.tolist() == pytest.approx([-rcan_ref.GRAY_MEAN])
    assert rcan_ref.GRAY_MEAN == pytest.approx(0.43683, abs=1e-5)


def test_create_rcan_serves_the_cascade():
    """``models.create("RCAN", 1, 1, 4)`` (10 groups of 20 RCABs, 64
    features) and ResDeconv through the fp32 predictor, within 1 LSB of the
    reference's uint8 answers."""
    sr = models.create("RCAN", 1, 1, 4)
    assert sum(isinstance(m, edsr_zoo.RCAB) for m in sr.modules()) == 200
    config = {"sr_model": dict(in_ch=1, ou_ch=1, up=4, n_resgroups=10, n_resblocks=20,
                               n_feats=64, reduction=16),
              "c_model": dict(src_ch=1, tar_ch=3, norm="GN", groups=32),
              "rcab_scale": 0.2, "group_scale": 0.2, "ca_up_scale": 4.0,
              "sr_out_scale": 0.05, "pred_scale": 0.03}
    gen = torch.Generator().manual_seed(2)
    p_sr = bench_cascade._draw(rcan_ref.specs(config["sr_model"]), gen, "cpu")
    p_sr.update(rcan_ref.constants(config["sr_model"]))
    p_c = bench_cascade._draw(ref.resdeconv_specs(config["c_model"]), gen, "cpu")
    zoo.scale_weights(p_sr, p_c, config)
    col = models.ResDeconv(1, 3)
    sr.load_state_dict(p_sr, strict=True)
    col.load_state_dict(p_c, strict=True)
    x = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    got = CascadePredictor(sr, col, 4, device="cpu").predict(x)
    want = rcan_ref.serve_u8(p_sr, p_c, config, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("cls", [SpatialShardedPredictor, SpatialShardedTiledPredictor])
@pytest.mark.parametrize("role", ["SR net", "colorizer"])
def test_strips_refuse_channel_attention(cls, role):
    rcan = models.create("RCAN", 1, 1, 4, **TINY)
    pair = (rcan, models.ResDeconv(1, 3)) if role == "SR net" else (models.ESPCN(1, 1, 4), rcan)
    with pytest.raises(ValueError, match=rf"{role}'s module body\.0\.body\.0\.body\.3 \(CALayer\)"):
        cls(*pair, 4, device="cpu")
