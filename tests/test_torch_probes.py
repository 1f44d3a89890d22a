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
    assert pk.matmul_int8_launches == 0


@pytest.mark.parametrize("sweep,lines", [(matmul_probe, 18), (mxu_probe, 8), (layout_probe3, 12)])
def test_entry_points_print_a_table_on_the_cpu(sweep, lines, capsys):
    """--device cpu: the plain versions at a small M, one line per shape of the
    script's sweep, and no rate."""
    assert sweep.main(["--device", "cpu"]) == []
    out = capsys.readouterr().out.splitlines()
    assert "cpu" in out[0] and "no rates" in out[0]
    assert sum("plain version" in line for line in out[1:]) == lines
    assert not any("FLOP/s" in line or "GB/s" in line for line in out)


@pytest.mark.parametrize("counts,whole", [((), False), ((5,), True), ((5, 10), True),
                                          ((4,), False), ((5, 9), False)],
                         ids=["empty", "one-a-call", "two-kernels", "lost-record", "one-lost"])
def test_profiler_session_is_whole_only_with_every_record(counts, whole):
    """A profiler session over 5 calls is taken again unless it holds device
    entries and each kernel ran a whole number of times a call."""
    from types import SimpleNamespace

    from srcgan_tpu_torch.probes import common

    events = [SimpleNamespace(key=f"k{i}", count=n) for i, n in enumerate(counts)]
    assert common.whole_session(events, 5) is whole


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


# -- the chain kernel of probe_mxu and probe_dots (csrc/probes.cu) ------------

def jax_chain(x, w, steps):
    """What decides each dot's successor in scripts/pallas_mxu_probe.py:31-37,
    restated from the full dot's y[0,0]: the bf16 perturbation
    bf16(y00 * 1e-36) as its bits, or the int8 parity y00 & 1."""
    is_int = jnp.issubdtype(x.dtype, jnp.integer)
    x2 = jnp.clip(x.astype(jnp.int32) + 1, -127, 127).astype(x.dtype) if is_int else x
    cur, out = x, []
    for _ in range(steps):
        y = dot32(cur, w, jnp.int32 if is_int else jnp.float32)
        if is_int:
            out.append(int(y[0, 0] & 1))
            cur = jnp.where((y[0, 0] & 1) == 0, x, x2)
        else:
            d = (y[0, 0] * jnp.float32(1e-36)).astype(cur.dtype)
            out.append(int(np.asarray(d).view(np.uint16)))
            cur = cur + d
    return out


@pytest.mark.parametrize("k,n", [(576, 192), (192, 128), (288, 128)])
def test_chain_steps_int8_parities_equal_jax(k, n):
    """The row-0 chain the plain versions use (and every warp of the kernel
    computes): the same parities as the full dots of the JAX kernel, bit for
    bit, on a pair whose chain takes both operands."""
    x, w = alternating_int8_pair(k, n)
    got = pk.chain_steps(torch.from_numpy(x), torch.from_numpy(w), 16)
    want = jax_chain(jnp.asarray(x), jnp.asarray(w), 16)
    assert got == want and 0 in got and 1 in got


@pytest.mark.parametrize("k,n", [(576, 192), (64, 192), (32, 64)])
def test_chain_steps_bf16_perturbations_equal_jax(k, n):
    """Each dot's bf16 perturbation from row 0 alone: bit-equal to the JAX
    kernel's from its full dot, all 16 of them."""
    x, w = bf16_pair(3 * k + n, 128, k, n)
    got = pk.chain_steps(t_bf16(x), t_bf16(w), 16)
    assert all(d.dtype == BF16 and d.dim() == 0 for d in got)
    bits = [int(d.view(torch.int16)) & 0xffff for d in got]
    assert bits == jax_chain(j_bf16(x), j_bf16(w), 16)
    assert all(b & 0x7FFF for b in bits)                         # a real perturbation, not 0


def test_one_rounding_of_a_bf16_sum_equals_two():
    """The kernel adds the perturbation with add.rn.bf16x2 (one rounding of
    the exact sum) where the plain version adds in fp32 and rounds to bf16:
    for two bf16 values the two agree, because the fp32 sum is exact wherever
    its rounding could move the bf16 result.  All exponent pairs, bit for
    bit (the exact sum taken in float64 where the exponents are within 40)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, (2, 400_000)).astype(np.uint32)
    finite = ((bits >> 7) & 0xFF != 0xFF).all(axis=0)
    xb, db = bits[:, finite]
    near = np.abs(((xb >> 7) & 0xFF).astype(int) - ((db >> 7) & 0xFF).astype(int)) <= 40
    x = torch.from_numpy((xb[near] << 16).view(np.float32))
    d = torch.from_numpy((db[near] << 16).view(np.float32))
    twice = (x + d).to(BF16).view(torch.int16)
    once = (x.double() + d.double()).to(BF16).view(torch.int16)
    assert near.sum() > 100_000 and torch.equal(twice, once)


SWEEP_SHAPES = ([(8320, k, n, torch.bfloat16) for k, n in mxu_probe.SHAPES]
                + [(8320, k, n, torch.int8) for k, n in mxu_probe.SHAPES]
                + [(16384, k, n, torch.bfloat16) for k, n in layout_probe3.DOT_SHAPES])


@pytest.mark.parametrize("m,k,n,dtype", SWEEP_SHAPES,
                         ids=[f"{'int8' if d == torch.int8 else 'bf16'}-{m}-{k}-{n}"
                              for m, k, n, d in SWEEP_SHAPES])
def test_chain_plan_every_sweep_shape(m, k, n, dtype):
    """The chain kernel's layout at every shape of both sweeps: a block's
    shared memory fits the card's 232,448 bytes (and two blocks an SM's 228 KB
    where it asks for two), probe_mxu's M=8320 fills at least 128 SMs, w stays
    resident, bf16 A lies in registers with w read as it lies and no scratch,
    int8 w is K-major (its image written first, a second launch)."""
    plan = pk.chain_plan(m, k, n, dtype)
    assert plan["smem_bytes"] <= pk.SMEM_PER_BLOCK
    if plan["ctas_per_sm"] == 2:
        assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    if m == 8320:
        assert plan["ctas"] >= 128 and plan["ctas"] == m // 64
    assert plan["w_resident"] and plan["k_class"] >= k and plan["rows_per_tile"] == 64
    steps = plan["k_class"] // (32 if dtype == torch.int8 else 16)
    assert sum(plan["warpgroup_steps"]) == (2 * steps if plan["split"] == "N" else steps)
    assert sum(plan["warpgroup_columns"]) == (n if plan["split"] == "N" else 2 * n)
    if dtype == torch.int8:
        assert plan["w_layout"].startswith("K-major") and plan["a_operand"] == "shared"
        assert plan["launches"] == 2 and plan["scratch_bytes"] >= k * n
    else:
        assert plan["w_layout"].startswith("MN-major") and plan["a_operand"] == "registers"
        assert plan["launches"] == 1 and plan["scratch_bytes"] == 0
        assert plan["split"] == ("N" if plan["k_class"] <= 128 and n >= 128 else "K")
    if plan["split"] == "K":
        assert plan["exchange_bytes"] == n * 256


def test_chain_plan_refuses_what_the_kernel_does_not_take():
    """K deeper than the deepest class, and what check_shape refuses."""
    with pytest.raises(ValueError, match="K <= 576"):
        pk.chain_plan(8320, 608, 192, torch.bfloat16)
    with pytest.raises(ValueError, match="N in"):
        pk.chain_plan(8320, 576, 96, torch.int8)
    with pytest.raises(ValueError, match="M % 64"):
        pk.chain_plan(100, 64, 64, torch.bfloat16)
    assert pk.chain_plan(64, 32, 64, torch.int8)["k_class"] == 64


@pytest.mark.parametrize("argv,match", [(["chain"], "no CUDA card"),
                                        (["chain", "--device", "cpu"], "no CPU mode")],
                         ids=["default-device", "cpu-asked"])
def test_chain_ablation_runs_only_on_the_card(monkeypatch, argv, match):
    """The ablation of the chain kernel is a named subcommand, like rdb5's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)


def test_chain_ablation_is_listed_and_times_the_shipped_design_first(capsys):
    """The usage names it; its first variant is the default build; a split
    variant runs only where the design that ships splits the other way; the
    table shapes of both probes are among its shapes."""
    from srcgan_tpu_torch.probes import chain_ablate

    assert probes_main.main(["--help"]) == {}
    assert "chain" in capsys.readouterr().out and "chain" in probes_main.NAMED_ONLY
    assert chain_ablate.VARIANTS[0][1] == ()
    assert ("PROBES_CHAIN=0",) in [d for _, d, _ in chain_ablate.VARIANTS]
    assert [d for _, d, _ in chain_ablate.LEAVE_OUT] == [(f"PROBES_CHAIN_LEAVE_OUT={k}",)
                                                          for k in (1, 2, 3)]
    shapes = [s[1:] for s in chain_ablate.SHAPES]
    assert (8320, 576, 192, torch.bfloat16) in shapes and (16384, 64, 192, torch.bfloat16) in shapes
    assert not chain_ablate.takes(("PROBES_CHAIN_SPLIT=1",), 16384, 64, 192, torch.bfloat16)
    assert chain_ablate.takes(("PROBES_CHAIN_SPLIT=0",), 16384, 64, 192, torch.bfloat16)
    assert not chain_ablate.takes(("PROBES_CHAIN_A_SMEM=1",), 8320, 576, 192, torch.bfloat16)


# -- probe_matmul's int8 GEMM and probe_stage1's kernel (csrc/probes.cu) ------

MATMUL_SHAPES = [(16384, k, n) for k in matmul_probe.DEPTHS for n in matmul_probe.WIDTHS]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES, ids=[f"{k}-{n}" for _, k, n in MATMUL_SHAPES])
def test_matmul8_plan_every_sweep_shape(m, k, n):
    """The int8 GEMM's layout at every shape of the matmul sweep: 128 blocks
    of 128 rows (one wave on 132 SMs), every chunk of 128 k of x and of w's
    K-major image resident in a block's 232,448 bytes, the image written by a
    launch of its own into a scratch that covers all of w."""
    plan = pk.matmul8_plan(m, k, n)
    assert plan["smem_bytes"] <= pk.SMEM_PER_BLOCK
    assert plan["ctas"] == m // 128 == 128 and plan["ctas"] <= 132
    assert plan["chunks"] == -(-k // 128) and plan["chunks"] * 128 >= k
    assert plan["smem_bytes"] >= plan["chunks"] * (plan["x_box_bytes"] + plan["w_chunk_bytes"])
    assert plan["x_box_bytes"] == 128 * 128 and plan["w_chunk_bytes"] == n * 128
    assert plan["w_resident"] and plan["w_layout"].startswith("K-major")
    assert plan["launches"] == 2 and plan["scratch_bytes"] >= k * n


def test_matmul8_plan_refuses_what_the_kernel_does_not_take():
    """K deeper than five chunks of 128, and what check_shape refuses."""
    assert pk.matmul8_plan(64, 640, 64)["chunks"] == 5
    with pytest.raises(ValueError, match="K <= 640"):
        pk.matmul8_plan(16384, 672, 192)
    with pytest.raises(ValueError, match="N in"):
        pk.matmul8_plan(16384, 576, 96)
    with pytest.raises(ValueError, match="M % 64"):
        pk.matmul8_plan(100, 64, 64)


@pytest.mark.parametrize("stride", [16, 128])
@pytest.mark.parametrize("form", pk.STAGE1_FORMS)
def test_stage1_plan_both_forms(form, stride):
    """probe_stage1's layout at strides 16 and 128: w resident in halves of 96
    columns, loaded once a block; a halo of stride + 1 rows (in boxes of 8)
    each way; the block's bytes within 232,448 (im2col: w's half, the 64 x 576
    tile and a halo tile); 66 pairs of blocks at M = 16384; two launches."""
    plan = pk.stage1_plan(16384, stride, form)
    halo = -(-(stride + 1) // 8) * 8
    assert plan["halo_rows"] == 64 + 2 * halo and halo >= stride + 1
    assert plan["smem_bytes"] <= pk.SMEM_PER_BLOCK and plan["halo_buffers"] == 1
    fixed = pk.STAGE1_HALF_BYTES + (pk.STAGE1_COL_BYTES if form == "im2col"
                                    else pk.STAGE1_EXCHANGE_BYTES)
    assert plan["smem_bytes"] >= fixed + plan["halo_rows"] * 128
    assert plan["w_resident"] and plan["w_loads_per_block"] == 1 and plan["half_columns"] == 96
    assert plan["ctas"] == 132 and plan["threads"] == 288 and plan["warpgroup_steps"] == (18, 18)
    assert plan["a_operand"].startswith("shared" if form == "im2col" else "registers")
    assert plan["launches"] == 2 and plan["scratch_bytes"] == 2 * 576 * 96 * 2


def test_stage1_plan_refuses_what_the_kernel_does_not_take():
    """A stride whose halo tile does not fit beside w's half (im2col holds
    strides <= 143, shifted <= 335), more than 32 stages, M % 64, a form."""
    pk.stage1_plan(16384, 143, "im2col")
    pk.stage1_plan(16384, 335, "shifted")
    with pytest.raises(ValueError, match="does not fit"):
        pk.stage1_plan(16384, 144, "im2col")
    with pytest.raises(ValueError, match="does not fit"):
        pk.stage1_plan(16384, 336, "shifted")
    with pytest.raises(ValueError, match="steps"):
        pk.stage1_plan(16384, 128, "shifted", steps=33)
    with pytest.raises(ValueError, match="M % 64"):
        pk.stage1_plan(100, 16, "im2col")
    with pytest.raises(ValueError, match="neither"):
        pk.stage1_plan(16384, 16, "stacked")
    assert pk.stage1_plan(64, 16, "shifted")["ctas"] == 2         # one tile: one pair


@pytest.mark.parametrize("argv,match", [(["matmul8"], "no CUDA card"),
                                        (["matmul8", "--device", "cpu"], "no CPU mode"),
                                        (["stage1"], "no CUDA card"),
                                        (["stage1", "--device", "cpu"], "no CPU mode")],
                         ids=["matmul8-default-device", "matmul8-cpu-asked",
                              "stage1-default-device", "stage1-cpu-asked"])
def test_matmul8_and_stage1_ablations_run_only_on_the_card(monkeypatch, argv, match):
    """Both ablations are named subcommands, like the chain's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)


def test_matmul8_and_stage1_ablations_time_the_shipped_design_first(capsys):
    """The usage names both; each times the default build first, then the
    option it beat, PR 5's design (its -D switch) and builds with work left
    out; the stage ablation at the sweep's stride and 16."""
    from srcgan_tpu_torch.probes import matmul8_ablate, stage1_ablate

    assert probes_main.main(["--help"]) == {}
    out = capsys.readouterr().out
    assert "matmul8" in out and "stage1" in out
    assert probes_main.NAMED_ONLY["matmul8"] is matmul8_ablate
    assert probes_main.NAMED_ONLY["stage1"] is stage1_ablate
    assert matmul8_ablate.VARIANTS[0][1] == () and stage1_ablate.VARIANTS[0][1] == ()
    assert ("PROBES_MM8=0",) in [d for _, d, _ in matmul8_ablate.VARIANTS]
    assert ("PROBES_MM8_IMAGE=0",) in [d for _, d, _ in matmul8_ablate.VARIANTS]
    assert [c for _, d, c in matmul8_ablate.VARIANTS if d == ("PROBES_MM_PRODUCTS=0",)] == [False]
    assert ("PROBES_STAGE1=0",) in [d for _, d in stage1_ablate.VARIANTS]
    assert [d for _, d in stage1_ablate.LEAVE_OUT] == [(f"PROBES_STAGE1_LEAVE_OUT={k}",)
                                                       for k in (1, 2, 3)]
    assert stage1_ablate.STRIDES[0] == 128 and 16 in stage1_ablate.STRIDES
    assert stage1_ablate.M == layout_probe3.M and stage1_ablate.STEPS == layout_probe3.STAGE_STEPS


@pytest.mark.parametrize("k,n", [(64, 64), (192, 128), (576, 192)])
def test_matmul8_sweep_copies_and_launches(k, n):
    """The copies of x the matmul sweep rotates over (and so its launches: two
    warm-ups and one capture a copy), which the int8 ablation rotates over
    too: 50, 20 and 9 at these shapes, 600 int8 launches over the nine and
    306 bf16."""
    assert matmul_probe.copies(16384, k, n) == {(64, 64): 50, (192, 128): 20, (576, 192): 9}[(k, n)]
    assert sum(3 * matmul_probe.copies(16384, kk, nn) for _, kk, nn in MATMUL_SHAPES) == 600
    assert sum(3 * matmul_probe.copies(16384, kk, nn, 2) for _, kk, nn in MATMUL_SHAPES) == 306


# -- probe_roll's cluster plan and probe_concat_dot on the chain kernel -------------

@pytest.mark.parametrize("m,shift", [(512, 0), (512, 511), (256, 1), (1024, 128), (384, 200)])
def test_roll_bit_equal_at_every_shift(m, shift):
    """The plain version against the restated JAX kernel (see above) at
    shift 0, M - 1 and shifts inside and across a block's rows, 1 and 16
    steps: bit-equal."""
    a = np.random.default_rng(m + shift).uniform(-1, 1, (m, 64)).astype(np.float32)
    a[0, :3] = [0.0, 1e-8, -1e-8]
    for steps in (1, 16):
        aa = j_bf16(a)
        for _ in range(steps):
            aa = jnp.roll(aa, shift, axis=0) + jnp.bfloat16(1e-8)
        got = pk.probe_roll(t_bf16(a), shift, steps)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(aa).view(np.int16))


@pytest.mark.parametrize("shift,remote", [(128, 128), (1, 1), (0, 0), (16383, 1), (2048, 2048),
                                          (5000, 2048)])
def test_roll_plan_of_the_sweep_shape(shift, remote):
    """(16384, 64) bf16, the sweep's shape: 16-byte pieces in clusters of 8
    blocks, 64 blocks of 2,048 rows, three buffers of 32 KB; the rows a block
    reads from another block after the cluster barrier; no grid barrier."""
    plan = pk.roll_plan(16384, 64, shift)
    assert (plan["cluster"], plan["piece_bytes"], plan["piece_columns"], plan["blocks"]) == (8, 16, 8, 64)
    assert plan["rows_per_block"] == 2048 and plan["smem_bytes"] == 3 * 2048 * 16
    assert plan["threads"] == 1024 and plan["barrier"] == "cluster" and not plan["grid_barrier"]
    assert plan["remote_rows"] == remote and plan["launches"] == 1
    from srcgan_tpu_torch.probes import roll_ablate
    assert tuple(layout[1:] for layout in roll_ablate.LAYOUTS) == pk.ROLL_LAYOUTS
    for _, cluster, piece in roll_ablate.LAYOUTS:       # every layout it times fits
        assert pk.roll_plan(roll_ablate.M, roll_ablate.C, 128, cluster, piece)["smem_bytes"] \
            <= pk.SMEM_PER_BLOCK
    one = pk.roll_plan(16384, 64, 128, 1, 4)
    assert (one["blocks"], one["rows_per_block"], one["barrier"], one["remote_rows"]) == \
        (32, 16384, "block", 0)


@pytest.mark.parametrize("m,c,cluster,piece,match", [
    (16388, 64, 8, 16, "8 must divide M"),                   # M not a multiple of the cluster
    (131072, 64, 8, 16, "fit its 232448 bytes"),             # a block's buffers too large
    (16384, 60, 8, 16, "does not cut into 16-byte pieces"),  # rows not whole pieces
    (16384, 64, 8, 4, "built for the layouts"),              # a layout not built
    (16384, 64, 4, 16, "built for the layouts"),
    (65536, 64, 1, 4, "fit its 232448 bytes")])
def test_roll_plan_refuses_what_the_kernel_does_not_take(m, c, cluster, piece, match):
    with pytest.raises(ValueError, match=match):
        pk.roll_plan(m, c, 1, cluster, piece)


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("form", ["concat", "twodots"])
def test_concat_dot_matches_the_restated_kernels_at_each_depth(form, steps):
    """Both forms against the restated JAX kernels at 1 and 8 steps; on the
    CPU the wrapper's plain version, which the card's chain kernel is held to
    (the y[0,0] chain of 1e-36 moves no operand here, so both are the same
    function)."""
    a, w = bf16_pair(21, 128, 64, 192)
    w = np.concatenate([w, bf16_pair(22, 1, 64, 192)[1]])
    want = jax_concat_dot(j_bf16(a), j_bf16(w), steps, form)
    got = pk.probe_concat_dot(t_bf16(a), t_bf16(w), steps, form)
    assert got.dtype == torch.float32 and rel_l2(got.numpy(), want) <= 1e-5
    assert pk.CONCAT_FORMS == ("concat", "twodots")


@pytest.mark.parametrize("argv,match", [(["roll"], "no CUDA card"),
                                        (["roll", "--device", "cpu"], "no CPU mode"),
                                        (["concat"], "no CUDA card"),
                                        (["concat", "--device", "cpu"], "no CPU mode")],
                         ids=["roll-default-device", "roll-cpu-asked", "concat-default-device",
                              "concat-cpu-asked"])
def test_roll_and_concat_ablations_run_only_on_the_card(monkeypatch, argv, match):
    """Both ablations are named subcommands, like the others."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        probes_main.main(argv)


def test_roll_and_concat_ablations_time_the_shipped_design_first(capsys):
    """The usage names both; the concat ablation times the default build
    first, then the options it was chosen over, the first design and builds
    with work left out; the roll ablation the first design beside its layouts."""
    from srcgan_tpu_torch.probes import concat_ablate, roll_ablate

    assert probes_main.main(["--help"]) == {}
    out = capsys.readouterr().out
    assert "roll" in out and "concat" in out
    assert probes_main.NAMED_ONLY["roll"] is roll_ablate
    assert probes_main.NAMED_ONLY["concat"] is concat_ablate
    assert concat_ablate.VARIANTS[0][1] == ()
    switches = [d for _, d in concat_ablate.VARIANTS]
    assert ("PROBES_CONCAT=0",) in switches and ("PROBES_CONCAT_SETS=2",) in switches
    assert ("PROBES_CONCAT_WALK=1",) in switches
    assert [d for _, d in concat_ablate.LEAVE_OUT] == [(f"PROBES_CHAIN_LEAVE_OUT={k}",) for k in (1, 2)]
    assert roll_ablate.FIRST_DESIGN == ("PROBES_ROLL=0",) and roll_ablate.SHIFTS == (1, 128)
    assert roll_ablate.M == layout_probe3.M and roll_ablate.STEPS == layout_probe3.ROLL_STEPS
    assert concat_ablate.M == layout_probe3.M and concat_ablate.STEPS == layout_probe3.PAIR_STEPS
