"""The port's probe functions (``ops.kernels.probe_kernels``) against the JAX
package's probe scripts, on the CPU at small M.

``make_matmul`` is the JAX function itself: ``scripts/pallas_matmul_probe.py``
is loaded by path and its ``pl.pallas_call`` runs in interpret mode.  The
other five kernels are local to functions that only print (and
``pallas_mxu_probe.py`` runs its sweep at import), so each body is restated
here in ``jax.numpy``, citing its lines, and the port's plain version is held
to it.  Tolerances: int8 forms and the roll bit-equal; bf16 dots rel-L2 <=
1e-5 on fp32 outputs (fp32 sums in another order); make_matmul's bf16 output
within one bf16 ulp of the output (the sum is rounded once).  On the CPU
every wrapper runs its plain version; the kernels themselves are compared
with it on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from srcgan_tpu_torch import probes
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import __main__ as probes_main
from srcgan_tpu_torch.probes import layout_probe3, matmul_probe, mxu_probe

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def bf16_pair(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (m, k)).astype(np.float32),
            rng.uniform(-1, 1, (k, n)).astype(np.float32))


def int8_pair(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-100, 100, (m, k)).astype(np.int8),
            rng.integers(-100, 100, (k, n)).astype(np.int8))


def t_bf16(a):
    return torch.from_numpy(a).to(BF16)


def j_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def dot32(x, w, acc_t=jnp.float32):
    return jax.lax.dot_general(x, w, (((1,), (0,)), ((), ())), preferred_element_type=acc_t)


@pytest.fixture(scope="module")
def matmul_script():
    """scripts/pallas_matmul_probe.py as a module, its pallas_call interpreted."""
    spec = importlib.util.spec_from_file_location(
        "pallas_matmul_probe", ROOT / "scripts" / "pallas_matmul_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        yield mod


@pytest.mark.parametrize("k,n", [(64, 64), (192, 128), (576, 192)])
def test_matmul_bf16_equals_the_jax_function(matmul_script, k, n):
    x, w = bf16_pair(k + n, 512, k, n)
    want = matmul_script.make_matmul(512, k, n, jnp.bfloat16, TM=256)(j_bf16(x), j_bf16(w))
    got = pk.probe_matmul(t_bf16(x), t_bf16(w))
    assert got.dtype == BF16 and tuple(got.shape) == want.shape == (512, n)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7      # one bf16 ulp, at least
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("k,n", [(64, 64), (192, 128), (576, 192)])
def test_matmul_int8_equals_the_jax_function(matmul_script, k, n):
    """The int32 sum cast to int8 wraps: bit-equal, and it does wrap here."""
    x, w = int8_pair(k + n, 512, k, n)
    want = matmul_script.make_matmul(512, k, n, jnp.int8, TM=256)(jnp.asarray(x), jnp.asarray(w))
    got = pk.probe_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(full).max() > 127                               # the cast really wraps
    np.testing.assert_array_equal(got.numpy(), full.astype(np.int8))


def jax_mxu(x, w, steps):
    """scripts/pallas_mxu_probe.py:25-38 (and 49-50 for x2), restated."""
    is_int = jnp.issubdtype(x.dtype, jnp.integer)
    acc_t = jnp.int32 if is_int else jnp.float32
    x2 = jnp.clip(x.astype(jnp.int32) + 1, -127, 127).astype(x.dtype) if is_int else x
    cur, acc, parities = x, jnp.zeros((x.shape[0], w.shape[1]), acc_t), []
    for _ in range(steps):
        y = dot32(cur, w, acc_t)
        acc = acc + y
        if is_int:
            parities.append(int(y[0, 0] & 1))
            cur = jnp.where((y[0, 0] & 1) == 0, x, x2)
        else:
            cur = cur + (y[0, 0] * jnp.float32(1e-36)).astype(cur.dtype)
    return acc, parities


@pytest.mark.parametrize("k,n", [(576, 128), (192, 128), (288, 128)])
def test_mxu_bf16_matches_the_restated_kernel(k, n):
    x, w = bf16_pair(k, 256, k, n)
    want, _ = jax_mxu(j_bf16(x), j_bf16(w), 16)
    got = pk.probe_mxu(t_bf16(x), t_bf16(w), 16)
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= 1e-5


def alternating_int8_pair(k, n):
    """An int8 pair whose chain takes both operands: y[0,0] of x is odd and
    y[0,0] of clip(x + 1) is even, so the selection alternates."""
    for seed in range(200):
        x, w = int8_pair(seed, 256, k, n)
        x2 = np.clip(x.astype(np.int32) + 1, -127, 127)
        y = int(x[0].astype(np.int64) @ w[:, 0].astype(np.int64))
        y2 = int(x2[0].astype(np.int64) @ w[:, 0].astype(np.int64))
        if y % 2 == 1 and y2 % 2 == 0:
            return x, w
    raise AssertionError("no alternating pair among 200 seeds")


@pytest.mark.parametrize("k,n", [(576, 192), (192, 128), (288, 128)])
def test_mxu_int8_matches_the_restated_kernel(k, n):
    """Bit-equal, on inputs where the selection really alternates: both
    operands are taken, so a wrong branch would change the sum."""
    x, w = alternating_int8_pair(k, n)
    want, parities = jax_mxu(jnp.asarray(x), jnp.asarray(w), 16)
    assert 0 in parities and 1 in parities
    got = pk.probe_mxu(torch.from_numpy(x), torch.from_numpy(w), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a chain that never switched operands would be 16 * (x @ w)
    assert not np.array_equal(got.numpy(), 16 * (x.astype(np.int32) @ w.astype(np.int32)))


def test_int8_next_is_a_saturating_byte_add():
    """clip(x + 1, -127, 127) over all int8 equals the signed saturating add of
    1 that the kernel applies to its fragments (x >= -128: only the top clips)."""
    x = np.arange(-128, 128, dtype=np.int8)
    want = np.clip(x.astype(np.int32) + 1, -127, 127).astype(np.int8)
    np.testing.assert_array_equal(pk._int8_next(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(np.clip(x.astype(np.int32) + 1, -128, 127).astype(np.int8), want)


@pytest.mark.parametrize("k,n", [(32, 192), (64, 64), (128, 128)])
def test_dots_matches_the_restated_kernel(k, n):
    """scripts/pallas_layout_probe3.py:75-83: the bf16 chain at shallow K."""
    x, w = bf16_pair(7 * k + n, 256, k, n)
    want, _ = jax_mxu(j_bf16(x), j_bf16(w), 16)
    got = pk.probe_dots(t_bf16(x), t_bf16(w), 16)
    assert rel_l2(got.numpy(), want) <= 1e-5
    with pytest.raises(ValueError, match="bfloat16"):
        pk.probe_dots(torch.zeros(64, k, dtype=torch.int8), torch.zeros(k, n, dtype=torch.int8))


def jax_concat_dot(a, w, steps, form):
    """scripts/pallas_layout_probe3.py:110-132 (k_concat, k_twodots), restated."""
    aa, acc = a, jnp.zeros((a.shape[0], w.shape[1]), jnp.float32)
    for _ in range(steps):
        if form == "concat":
            y = dot32(jnp.concatenate([aa, aa * 0.5], axis=1), w)
        else:
            y = dot32(aa, w[:64]) + dot32(aa * 0.5, w[64:])
        acc = acc + y
        aa = aa + (y[0, 0] * jnp.float32(1e-36)).astype(aa.dtype)
    return acc


@pytest.mark.parametrize("form", ["concat", "twodots"])
def test_concat_dot_matches_the_restated_kernels(form):
    a, w = bf16_pair(11, 256, 64, 192)
    w = np.concatenate([w, bf16_pair(12, 1, 64, 192)[1]])        # (128, 192)
    want = jax_concat_dot(j_bf16(a), j_bf16(w), 8, form)
    got = pk.probe_concat_dot(t_bf16(a), t_bf16(w), 8, form)
    assert got.shape == (256, 192) and rel_l2(got.numpy(), want) <= 1e-5
    other = pk.probe_concat_dot(t_bf16(a), t_bf16(w), 8,
                                "twodots" if form == "concat" else "concat")
    assert rel_l2(other.numpy(), want) <= 1e-5                   # the same function
    with pytest.raises(ValueError, match="neither"):
        pk.probe_concat_dot(t_bf16(a), t_bf16(w), 8, "stacked")


@pytest.mark.parametrize("shift", [1, 128, -3])
def test_roll_is_bit_equal_to_the_restated_kernel(shift):
    """scripts/pallas_layout_probe3.py:160-165: 16 rolls, each + bf16(1e-8)."""
    a = np.random.default_rng(2).uniform(-1, 1, (512, 64)).astype(np.float32)
    a[0, :4] = [0.0, 1e-8, -1e-8, 3e-9]                         # where the add is not a no-op
    aa = j_bf16(a)
    for _ in range(16):
        aa = jnp.roll(aa, shift, axis=0)
        aa = aa + jnp.bfloat16(1e-8)
    got = pk.probe_roll(t_bf16(a), shift, 16)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(aa).view(np.int16))
    assert not np.array_equal(got.float().numpy(), np.asarray(j_bf16(a), np.float32))


def jax_stage1(x, w, steps, stride):
    """scripts/pallas_layout_probe3.py:196-212, restated with the row stride W
    as an argument (the script has W = 128)."""
    xx, acc = x, jnp.zeros((x.shape[0], w.shape[1]), jnp.float32)
    for _ in range(steps):
        cols = []
        for dy in (-stride, 0, stride):
            for dx in (-1, 0, 1):
                s = dy + dx
                cols.append(xx if s == 0 else jnp.roll(xx, s, axis=0))
        y = dot32(jnp.concatenate(cols, axis=1), w)
        acc = acc + y
        xx = xx + (y[0, 0] * jnp.float32(1e-36)).astype(xx.dtype)
    return acc


@pytest.mark.parametrize("stride,form", [(16, "im2col"), (16, "shifted"), (128, "im2col")])
def test_stage1_matches_the_restated_kernel(stride, form):
    x, w = bf16_pair(3, 512, 64, 192)
    w = np.random.default_rng(4).uniform(-1, 1, (576, 192)).astype(np.float32)
    want = jax_stage1(j_bf16(x), j_bf16(w), 4, stride)
    got = pk.probe_stage1(t_bf16(x), t_bf16(w), 4, stride, form)
    assert got.shape == (512, 192) and rel_l2(got.numpy(), want) <= 1e-5
    assert pk.tap_shifts(stride) == (-stride - 1, -stride, -stride + 1, -1, 0, 1,
                                     stride - 1, stride, stride + 1)


def test_wrappers_refuse_what_they_do_not_take():
    x, w = t_bf16(bf16_pair(0, 64, 64, 64)[0]), t_bf16(bf16_pair(0, 64, 64, 64)[1])
    with pytest.raises(ValueError, match="one type"):
        pk.probe_matmul(x, w.float())
    with pytest.raises(ValueError, match="2-D"):
        pk.probe_mxu(x[0], w)
    with pytest.raises(ValueError, match="rows"):
        pk.probe_concat_dot(x, w)                                # w must have 128 rows
    with pytest.raises(ValueError, match="rows"):
        pk.probe_stage1(x, w)                                    # w must have 576 rows
    with pytest.raises(ValueError, match="bf16"):
        pk.probe_roll(x.float(), 1)
    assert set(pk.launches) == set(pk.NAMES) and not any(pk.launches.values())


@pytest.mark.parametrize("sweep,lines", [(matmul_probe, 18), (mxu_probe, 8), (layout_probe3, 12)])
def test_entry_points_print_a_table_on_the_cpu(sweep, lines, capsys):
    """--device cpu: the plain versions at a small M, one line per shape of the
    script's sweep, and no rate."""
    assert sweep.main(["--device", "cpu"]) == []
    out = capsys.readouterr().out.splitlines()
    assert "cpu" in out[0] and "no rates" in out[0]
    assert sum("plain version" in line for line in out[1:]) == lines
    assert not any("FLOP/s" in line or "GB/s" in line for line in out)


def test_entry_points_raise_without_a_card(monkeypatch, capsys):
    """The default device is the card: without one the error names --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        probes_main.main(["mxu"])
    assert probes_main.main(["layout", "c", "--device", "cpu"]).keys() == {"layout"}
    out = capsys.readouterr().out
    assert "C. roll" in out and "A. bf16" not in out
    with pytest.raises(SystemExit):
        probes_main.main(["layout", "ab", "cd", "--device", "cpu"])
    assert probes.__doc__ and "python -m srcgan_tpu_torch.probes" in probes.__doc__


@pytest.mark.parametrize("argv,match", [(["rdb5"], "no CUDA card"),
                                        (["rdb5", "--device", "cpu"], "no CPU mode")],
                         ids=["default-device", "cpu-asked"])
def test_rdb5_ablation_runs_only_on_the_card(monkeypatch, argv, match):
    """The ablation of csrc/rdb5.cu's variants is a named subcommand; it
    raises without a card, and names the card when asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)


@pytest.mark.parametrize("argv,match", [(["ssim"], "no CUDA card"),
                                        (["ssim", "--device", "cpu"], "no CPU mode")],
                         ids=["default-device", "cpu-asked"])
def test_ssim_ablation_runs_only_on_the_card(monkeypatch, argv, match):
    """The ablation of csrc/ssim.cu is a named subcommand, like rdb5's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)


def test_ssim_ablation_times_the_shipped_design_first():
    """Its first variant is the default build at the wrapper's rows a block,
    the one ssim_fused launches; the others change one choice each, and
    every build with work left out keeps the shipped grid."""
    from srcgan_tpu_torch.ops.kernels import ssim_kernel
    from srcgan_tpu_torch.probes import ssim_ablate

    assert ssim_ablate.VARIANTS[0][1:] == ((), ssim_kernel.TILE)
    assert all(len(d) + (r != ssim_kernel.TILE) == 1 for _, d, r in ssim_ablate.VARIANTS[1:])
    assert [d for _, d, _ in ssim_ablate.LEAVE_OUT] == [(f"SSIM_LEAVE_OUT={k}",) for k in (1, 2, 3)]
    assert all(r == ssim_kernel.TILE for _, _, r in ssim_ablate.LEAVE_OUT)
    n, h, w, c = ssim_ablate.SHAPE
    assert ssim_kernel.strip_width(c) == 32 and (h, w) == (256, 256)


def test_entry_point_lists_the_rdb5_ablation(capsys):
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel
    from srcgan_tpu_torch.probes import rdb5_ablate

    assert probes_main.main(["--help"]) == {}
    out = capsys.readouterr().out
    assert "probes rdb5" in out and "matmul|mxu|layout" in out
    with pytest.raises(SystemExit):
        probes_main.main(["rdb5", "mxu"])
    # the last variant is the default build, the one the wrappers launch
    assert rdb5_ablate.VARIANTS[-1][1] == () and len(rdb5_ablate.VARIANTS) == 5
    assert rdb5_ablate.SHAPE[3] == rdb5_kernel.NF
    assert rdb5_kernel.supported(rdb5_ablate.SHAPE, rdb5_kernel.NF, rdb5_kernel.GC)


@pytest.mark.parametrize("m,k,n,ok", [(16384, 576, 192, True), (64, 32, 64, True),
                                      (128, 192, 128, True), (100, 64, 64, False),
                                      (64, 48, 64, False), (64, 64, 96, False)])
def test_probe_matmul_shape_gate(m, k, n, ok):
    """What the card takes for probe_matmul, in both types: M % 64, K % 32, N in
    (64, 128, 192), as before the bf16 form had a kernel of its own."""
    if ok:
        pk.check_shape("probe_matmul", m, k, n)
    else:
        with pytest.raises(ValueError, match="N in"):
            pk.check_shape("probe_matmul", m, k, n)


@pytest.mark.parametrize("argv,match", [(["tail"], "no CUDA card"),
                                        (["tail", "--device", "cpu"], "no CPU mode")],
                         ids=["default-device", "cpu-asked"])
def test_tail_ablation_runs_only_on_the_card(monkeypatch, argv, match):
    """The tail kernel against its first design is a named subcommand too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)
