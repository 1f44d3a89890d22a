"""The RCAN cell's counts of work against hand counts, and its weights'
draw against the program's module."""
import pytest
import torch

from portbench import flops, zoo

RCAN_X4 = {"in_ch": 1, "ou_ch": 1, "up": 4, "n_resgroups": 10, "n_resblocks": 20,
           "n_feats": 64, "reduction": 16}
COLOR = {"tar_ch": 3}


def test_rcan_per_pixel():
    trunk = 411 * 2 * 9 * 64 * 64                      # 10 x (20 x 2 + 1) + 1 convs 64->64
    upsampler = 2 * 9 * 64 * 256 * (1 + 4)             # conv to 256 at 1x, then at 2x
    ends = 2 * 9 * 1 * 64 + 2 * 9 * 64 * 1 * 16        # head at 1x, last conv at 4x
    assert zoo.rcan_per_pixel(RCAN_X4) == trunk + upsampler + ends == 31_796_352


def test_rcab_conv_per_pixel():
    assert zoo.rcab_conv_per_pixel() == 2 * 9 * 64 * 64 == 73_728


def test_cascade_forward_at_the_stream_batch():
    n, side = 32, 128
    attention = 200 * 2 * (2 * 64 * 4)
    want = n * side * side * 31_796_352 + n * attention + n * flops.resdeconv(512, 512)
    assert zoo.cascade_forward(n, side, side, RCAN_X4, COLOR) == want
    assert want == pytest.approx(21.0e12, rel=0.02)    # a batch's work, about 21 TFLOP


def test_weights_fill_the_program_module():
    """Every entry of the drawn dict is a state-dict entry of the port's
    RCAN of the same widths, and the reverse."""
    from portbench.reference import rcan as rcan_ref
    from srcgan_tpu_torch import models

    cfg = dict(RCAN_X4, n_resgroups=2, n_resblocks=3)
    specs = {name: shape for name, shape, _, _ in rcan_ref.specs(cfg)}
    specs.update({k: tuple(v.shape) for k, v in rcan_ref.constants(cfg).items()})
    net = models.create("RCAN", 1, 1, 4, n_resgroups=2, n_resblocks=3)
    assert specs == {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert torch.equal(net.state_dict()["add_mean.bias"], rcan_ref.constants(cfg)["add_mean.bias"])


def test_rcab_conv_bytes():
    px = 32 * 128 * 128
    assert zoo.rcab_conv_bytes(px) == 2 * px * 64 * 2 + (9 * 64 * 64 + 64) * 2
    least = flops.least_time(zoo.rcab_conv_bytes(px), zoo.rcab_conv_per_pixel() * px, "bf16")
    assert least["bound_by"] == "bytes" and least["seconds"] == pytest.approx(40.1e-6, rel=0.01)


def test_spans_of_a_traced_run():
    """A traced run's spans on RCAN: the cascade's, one ``ca`` on each
    channel attention, one ``rcab_conv`` on each of an RCAB's two convs;
    a forward records each span's input shape."""
    from types import SimpleNamespace

    from portbench import tracing
    from srcgan_tpu_torch import models

    sr = models.create("RCAN", 1, 1, 4, n_resgroups=2, n_resblocks=3, n_feats=16, reduction=4)
    col = models.ResDeconv(1, 3, BN="GN")
    spans = tracing.Spans()
    zoo.hook_spans(spans, SimpleNamespace(sr_model=sr, c_model=col))
    with torch.no_grad():
        sr(torch.rand(2, 1, 8, 8))
    spans.remove()
    assert spans.shapes["ca"] == {(2, 16, 8, 8)}
    assert spans.shapes["rcab_conv"] == {(2, 16, 8, 8)}
    assert spans.shapes["sr_net"] == {(2, 1, 8, 8)}
    assert not sr._forward_hooks and not sr._forward_pre_hooks
