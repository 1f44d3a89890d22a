"""The benchmark's counts of work against hand counts."""
import pytest

from portbench import flops

SR_X4 = {"in_ch": 1, "ou_ch": 1, "up": 4, "nf": 64, "nb": 3, "gc": 32}
COLOR = {"tar_ch": 3}


def test_rdb5_per_pixel():
    # 2 * 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64)
    assert flops.rdb5_per_pixel() == 479_232


def test_tail_x4_per_trunk_pixel_and_at_the_serving_shape():
    # deconv 2x2 64->64 at 1x and 2x, conv_last 3x3 64->1 at 4x, per trunk pixel
    assert flops.tail_per_trunk_pixel() == 2 * 64 * 64 * 4 * (1 + 4) + 2 * 9 * 64 * 16
    assert flops.tail_per_trunk_pixel() == 182_272
    assert flops.tail_per_trunk_pixel() * 8 * 128 * 128 == pytest.approx(23.9e9, rel=1e-3)


def test_rddbnet_by_layer():
    per_px = 2 * 9 * 64 + 9 * 479_232 + 2 * 9 * 64 * 64 + 182_272
    assert flops.rddbnet(8 * 128 * 128) == per_px * 8 * 128 * 128
    # x2: one deconv at 1x, conv_last at 2x
    x2 = 2 * 9 * 64 + 9 * 479_232 + 2 * 9 * 64 * 64 + 2 * 64 * 64 * 4 + 2 * 9 * 64 * 4
    assert flops.rddbnet(100, up=2) == 100 * x2


def test_resdeconv_by_layer():
    h = w = 64
    px = lambda s: (h // s) * (w // s)  # noqa: E731
    conv = lambda i, o, k, p: 2 * i * o * k * k * p  # noqa: E731
    block = lambda i, o, s: conv(i, o, 3, px(s)) + conv(o, o, 3, px(s)) + (  # noqa: E731
        conv(i, o, 1, px(s)) if i != o else 0)
    stage = lambda i, o, s: block(i, o, s) + block(o, o, s)  # noqa: E731
    want = (conv(3, 64, 7, px(2)) + stage(64, 64, 2) + stage(64, 128, 4) + stage(128, 256, 8)
            + stage(256, 512, 16)
            + 2 * 512 * 256 * 4 * px(16) + stage(256, 256, 8)
            + 2 * 256 * 128 * 4 * px(8) + stage(128, 128, 4)
            + 2 * 128 * 64 * 4 * px(4) + stage(64, 64, 2)
            + 2 * 64 * 64 * 4 * px(2) + conv(64, 3, 3, px(1)))
    assert flops.resdeconv(h, w) == want


def test_cascade_and_train_step_by_shape():
    fwd = flops.cascade_forward(8, 128, 128, SR_X4, COLOR)
    assert fwd == flops.rddbnet(8 * 128 * 128) + 8 * flops.resdeconv(512, 512)
    assert fwd == pytest.approx(1.69e12, rel=1e-3)
    sr_x2 = dict(SR_X4, up=2)
    step = flops.train_step(32, 256, sr_x2, COLOR)
    assert step == 3 * (flops.rddbnet(32 * 128 * 128, up=2) + 32 * flops.resdeconv(256, 256))


def test_least_time():
    # chip_smoke.least_time's arithmetic: the larger of bytes / 3.35 TB/s and ops / peak
    t = flops.least_time(3.35e9, 989e9, "bf16")
    assert t["seconds"] == pytest.approx(1e-3) and t["bound_by"] == "bytes"
    t = flops.least_time(1.0, 989e12, "bf16")
    assert t["seconds"] == pytest.approx(1.0) and t["bound_by"] == "operations"
    rdb5 = flops.least_time(flops.rdb5_bytes(8 * 128 * 128), 479_232 * 8 * 128 * 128, "bf16")
    assert rdb5["seconds"] == pytest.approx(0.0635e-3, rel=1e-2)
