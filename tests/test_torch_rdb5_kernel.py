"""The port's RDB5 kernel module against the JAX package's, on the CPU.

The same weights and inputs (numpy, from a seed) go through
``srcgan_tpu.ops.pallas.rdb5_kernel`` (its XLA statement and the Pallas kernel
in interpret mode) and ``srcgan_tpu_torch.ops.kernels.rdb5_kernel`` (the plain
versions: on a CPU tensor the wrappers run those).  Tolerances: the int8 form
rel-L2 < 1e-2 and the bf16 form rel-L2 < 2e-2, the bounds of
tests/test_quant_kernel.py (a 1-ulp difference in the fp32 dequant chain can
flip a requantization round; bf16 staging rounds at other places); operands:
int8 weights bit-equal, scales rtol 1e-6; the fp32 block forms atol 1e-5
(the order of float sums).

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).  What
surrounds its arithmetic is held here: a torch repeat of its tiling (tiles of
TILE_H x TILE_W outputs with a HALO-pixel halo, by stage, zero outside the
image, ragged last tile), the order in which its bulk copies, ldmatrix and the
wgmma descriptor read the weights, and its shared-memory swizzle.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from srcgan_tpu.models.blocks import ResidualDenseBlock5 as JaxBlock
from srcgan_tpu.ops.pallas import rdb5_kernel as K
from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5, rdb5_schedule
from srcgan_tpu_torch.ops.kernels import rdb5_kernel as T

WIDTHS = (32, 32, 32, 32, 64)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def port_block(params) -> ResidualDenseBlock5:
    """The port's block with the JAX block's weights (HWIO -> OIHW)."""
    blk = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
    with torch.no_grad():
        for i in range(5):
            conv = getattr(blk, f"conv{i + 1}")
            p = params[f"conv{i + 1}"]
            conv.weight.copy_(torch.from_numpy(np.array(p["w"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(np.array(p["b"])))
    return blk


def setup(shape=(1, 16, 128, 64), seed=0):
    """JAX block + params, the port's block, an input and the concat's absmax."""
    rng = np.random.default_rng(seed)
    jblk = JaxBlock(64, 32)
    params = jblk.init(jax.random.PRNGKey(seed))
    # non-zero biases: the zero-outside-the-image rule only shows with them
    params = {k: {"w": v["w"], "b": jnp.asarray(rng.normal(0, 0.1, v["b"].shape), jnp.float32)}
              for k, v in params.items()}
    x = rng.uniform(-0.5, 1.5, shape).astype(np.float32)
    _, cat = jblk.forward_with_sources(params, jnp.asarray(x))
    absmax = np.asarray(jnp.max(jnp.abs(cat), axis=(0, 1, 2)))
    return jblk, params, port_block(params), x, absmax


@pytest.fixture(scope="module")
def case():
    return setup()


def test_prep_int8_operands_equal_jax(case):
    _, params, blk, _, absmax = case
    ours = T.prep_int8(blk.convs(), torch.from_numpy(absmax))
    wq, sw, rq, bias = K.prep_int8(params, jnp.asarray(absmax))
    for s in range(5):
        assert ours.wq[s].dtype == torch.int8
        np.testing.assert_array_equal(ours.wq[s].numpy(), np.asarray(wq[s]))
    np.testing.assert_allclose(ours.sw.numpy(), np.asarray(sw), rtol=1e-6)
    np.testing.assert_allclose(ours.rq.numpy(), np.asarray(rq), rtol=1e-6)
    np.testing.assert_allclose(ours.bias.numpy(), np.asarray(bias), rtol=1e-6)
    # zero padding of the (5, 64) vectors beyond each stage's / source's width
    assert not ours.sw[:4, 32:].any() and not ours.rq[1:, 32:].any() and not ours.bias[:4, 32:].any()


def test_prep_int8_guards():
    """A dead channel (absmax 0) and an all-zero filter quantize to finite operands."""
    blk = ResidualDenseBlock5(64, 32).requires_grad_(False)
    with torch.no_grad():
        blk.conv2.weight[3].zero_()
    w = T.prep_int8(blk.convs(), torch.zeros(192))
    assert all(torch.isfinite(t).all() for t in (w.sw, w.rq, w.bias))
    assert w.sw[1, 3] == pytest.approx(1e-30) and w.rq[0, 0] == pytest.approx(127.0 / 1e-8)


def test_prep_bf16_operands_equal_jax(case):
    _, params, blk, _, _ = case
    ours = T.prep_bf16(blk.convs())
    wsrc, bias = K.prep_bf16(params)
    for s in range(5):
        assert ours.wsrc[s].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.wsrc[s].float().numpy(),
                                      np.asarray(wsrc[s].astype(jnp.float32)))
    np.testing.assert_array_equal(ours.bias.numpy(), np.asarray(bias))


def test_int8_reference_matches_jax_xla(case):
    _, params, blk, x, absmax = case
    want = K.rdb5_int8_xla(jnp.asarray(x), params, jnp.asarray(absmax))
    got = T.rdb5_int8_fused(torch.from_numpy(x), T.prep_int8(blk.convs(), torch.from_numpy(absmax)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert rel_l2(got.numpy(), want) < 1e-2


def test_int8_reference_matches_pallas_interpret(case):
    _, params, blk, x, absmax = case
    want = K.rdb5_int8_fused(jnp.asarray(x), params, jnp.asarray(absmax), interpret=True)
    got = T.rdb5_int8_reference(torch.from_numpy(x),
                                T.prep_int8(blk.convs(), torch.from_numpy(absmax)))
    assert rel_l2(got.numpy(), want) < 1e-2


def test_bf16_reference_matches_pallas_interpret():
    jblk, params, blk, x, _ = setup((1, 8, 128, 64), seed=9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = K.rdb5_bf16_fused(xb, pb, interpret=True).astype(jnp.float32)
    got = T.rdb5_bf16_fused(torch.from_numpy(x).to(torch.bfloat16), T.prep_bf16(blk.convs()))
    assert got.dtype == torch.bfloat16
    assert rel_l2(got.float().numpy(), want) < 2e-2
    # and both track the fp32 block
    fp32 = jblk._forward_naive(params, jnp.asarray(x))
    assert rel_l2(got.float().numpy(), fp32) < 2e-2


def test_int8_semantics_close_to_fp32(case):
    jblk, params, blk, x, absmax = case
    fp32 = jblk._forward_naive(params, jnp.asarray(x))
    got = T.rdb5_int8_reference(torch.from_numpy(x),
                                T.prep_int8(blk.convs(), torch.from_numpy(absmax)))
    assert rel_l2(got.numpy(), fp32) < 0.06


@pytest.mark.parametrize("schedule", ["naive", "grouped", "fused"])
def test_block_forms_match_jax(case, schedule):
    """fp32 on the CPU: "fused" takes the grouped form (the kernel is bf16)."""
    jblk, params, blk, x, _ = case
    want = (jblk._forward_grouped if schedule == "grouped" else jblk._forward_naive)(
        params, jnp.asarray(x))
    with torch.no_grad(), rdb5_schedule(schedule):
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_forward_with_sources_matches_jax(case):
    jblk, params, blk, x, _ = case
    want_y, want_cat = jblk.forward_with_sources(params, jnp.asarray(x))
    with torch.no_grad():
        y, cat = blk.forward_with_sources(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(want_y), atol=1e-5)
    # x4 has passed four convolutions and reaches |v| ~ 10: relative to its size
    np.testing.assert_allclose(cat.permute(0, 2, 3, 1).numpy(), np.asarray(want_cat),
                               rtol=1e-4, atol=1e-5)


def test_schedule_context():
    from srcgan_tpu_torch.models import blocks

    # nothing scoped is the default by its name: "naive" means cuDNN only, the
    # default takes the kernel where it can
    assert blocks.DEFAULT_RDB5_SCHEDULE == "auto"
    assert blocks.current_rdb5_schedule() == "auto"
    with rdb5_schedule("fused"):
        assert blocks.current_rdb5_schedule() == "fused"
        with rdb5_schedule("grouped"):
            assert blocks.current_rdb5_schedule() == "grouped"
        with rdb5_schedule("auto"):
            assert blocks.current_rdb5_schedule() == "auto"
        assert blocks.current_rdb5_schedule() == "fused"
    with rdb5_schedule("naive"):
        assert blocks.current_rdb5_schedule() == "naive"
    assert blocks.current_rdb5_schedule() == "auto"
    with pytest.raises(ValueError, match="paired"):
        with rdb5_schedule("paired"):
            pass


def test_fused_schedule_takes_the_bf16_wrapper_only_where_it_may(case):
    """Eval, bf16 and a supported shape -> rdb5_bf16_fused (on the CPU its
    plain version, once per forward, operands prepared once); training mode,
    fp32 or an unsupported shape -> the grouped form."""
    _, _, blk, x, _ = case
    blk = ResidualDenseBlock5(64, 32).requires_grad_(False)
    blk.load_state_dict(case[2].state_dict())
    blk = blk.to(torch.bfloat16).eval()
    xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    before = T.reference_calls, T.launches_bf16, T.launches_int8
    with torch.no_grad(), rdb5_schedule("fused"):
        y = blk(xb)
        prepared = blk._prepared[1]
        blk(xb)
        assert blk._prepared[1] is prepared
        assert T.reference_calls == before[0] + 2
        blk(xb[:, :, :, :100])                      # W % 128 != 0
        blk.train()
        blk(xb)
        blk.eval()
        assert T.reference_calls == before[0] + 2
        grouped = blk._forward_grouped(xb)
    assert (T.launches_bf16, T.launches_int8) == before[1:]
    want = T.rdb5_bf16_reference(xb.permute(0, 2, 3, 1).contiguous(), T.prep_bf16(blk.convs()))
    assert torch.equal(y.permute(0, 2, 3, 1), want)
    assert rel_l2(y.float().numpy(), grouped.float().numpy()) < 2e-2
    with torch.no_grad():
        blk.conv3.weight.mul_(0.5)                  # a new weight set: operands rebuilt
    with torch.no_grad(), rdb5_schedule("fused"):
        blk(xb)
    assert blk._prepared[1] is not prepared


def test_no_schedule_scoped_stays_naive_on_the_cpu(case):
    """With no schedule scoped the kernel is the route only for a CUDA
    tensor: a CPU forward of an eval bf16 block on a supported shape runs the
    naive form, bit for bit, and no plain version of the kernel."""
    blk = ResidualDenseBlock5(64, 32).requires_grad_(False)
    blk.load_state_dict(case[2].state_dict())
    blk = blk.to(torch.bfloat16).eval()
    xb = torch.from_numpy(case[3]).to(torch.bfloat16).permute(0, 3, 1, 2)
    assert blk._kernel_takes(xb)
    before = T.reference_calls, T.launches_bf16
    with torch.no_grad():
        got = blk(xb)
        with rdb5_schedule("naive"):
            want = blk(xb)
    assert (T.reference_calls, T.launches_bf16) == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,ok", [
    ((1, 16, 100, 64), False),     # w % 128 != 0
    ((1, 4, 128, 64), False),      # h too small
    ((1, 16, 128, 48), False),     # c != nf
    ((1, 16, 640, 64), False),     # w > 512
    ((2, 128, 128, 64), True),
    ((1, 15, 128, 64), True),      # odd h
    ((1, 512, 128, 64), True),
    ((8, 128, 512, 64), True),
])
def test_supported(shape, ok):
    assert T.supported(shape, 64, 32) is ok
    if shape[3] == 64 and (ok or shape[1] % 8 == 0):
        assert K.supported(shape, 64, 32) is ok     # the JAX gate, where the TPU's tiling allows
    assert not T.supported(shape, 32, 32) and not T.supported(shape, 64, 16)


# -- the kernel's tiling, repeated in torch -----------------------------------

def tiled_block(x, w, quant, lemda=0.2, alpha=0.2):
    """What csrc/rdb5.cu computes, tile by tile (TILE_H x TILE_W outputs): x
    with a HALO-pixel halo, zero outside the image; stage i on its region, the
    tile grown by HALO - 1 - i pixels each way, as the sum over sources
    j <= i of a VALID 3x3 convolution of source j's tile; x_{i+1} zero outside
    the image; the tile's centre written where it is inside."""
    th, tw, halo = T.TILE_H, T.TILE_W, T.HALO
    n, h, wd, _ = x.shape
    mats = w.wq if quant else w.wsrc
    dt = torch.float64 if quant else torch.float32
    x32 = x.float()
    out = torch.zeros_like(x32)
    xp = F.pad(x32, (0, 0, halo, halo + tw, halo, halo + th))

    def as_source(v, s):
        if quant:
            return torch.round(v * w.rq[s, :v.shape[-1]]).clamp(-127, 127)
        return v.to(torch.bfloat16).float()

    for ty0 in range(0, h, th):
        for tx0 in range(0, wd, tw):
            tiles = [as_source(xp[:, ty0:ty0 + th + 2 * halo, tx0:tx0 + tw + 2 * halo], 0)]
            for i in range(5):
                grow = halo - 1 - i                 # the stage's region around the tile
                rh, rw = th + 2 * grow, tw + 2 * grow
                pre = 0
                for j in range(i + 1):
                    cj, col0 = (64 if j == 0 else 32), sum(WIDTHS[j:i])
                    wij = mats[j][:, col0:col0 + WIDTHS[i]].reshape(3, 3, cj, -1)
                    crop = tiles[j][:, i - j:i - j + rh + 2, i - j:i - j + rw + 2]
                    y = F.conv2d(crop.permute(0, 3, 1, 2).to(dt),
                                 wij.permute(3, 2, 0, 1).to(dt)).permute(0, 2, 3, 1)
                    pre = pre + (y.round().to(torch.int64) if quant else y)
                v = pre.float()
                if quant:
                    v = v * w.sw[i, :WIDTHS[i]]
                v = v + w.bias[i, :WIDTHS[i]]
                if i == 4:
                    break
                gy = torch.arange(ty0 - grow, ty0 - grow + rh).view(1, rh, 1, 1)
                gx = torch.arange(tx0 - grow, tx0 - grow + rw).view(1, 1, rw, 1)
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
                v = torch.where(inside, torch.where(v >= 0, v, alpha * v), torch.zeros(()))
                tiles.append(as_source(v, i + 1))
            rows = min(th, h - ty0)
            out[:, ty0:ty0 + rows, tx0:tx0 + tw] = (v[:, :rows] * lemda
                                                    + x32[:, ty0:ty0 + rows, tx0:tx0 + tw])
    return out.to(x.dtype)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(1, 15, 128, 64), (2, 40, 128, 64)],
                         ids=["ragged-one-row-of-tiles", "three-rows-of-tiles"])
def test_kernel_tiling_matches_plain_version(shape, quant):
    """Every image edge falls inside some tile's halo, and the last tile row
    is ragged (15 and 40 are no multiples of the tile's height)."""
    assert 15 % T.TILE_H and 40 % T.TILE_H and 128 % T.TILE_W == 0
    _, _, blk, x, absmax = setup(shape, seed=3)
    # with zero biases a missing border mask would not show (lrelu(0) = 0)
    assert all(b.abs().max() > 0.01 for _, b in blk.convs())
    if quant:
        w = T.prep_int8(blk.convs(), torch.from_numpy(absmax))
        xt = torch.from_numpy(x)
        assert torch.equal(tiled_block(xt, w, True), T.rdb5_int8_reference(xt, w))
    else:
        w = T.prep_bf16(blk.convs())
        xt = torch.from_numpy(x).to(torch.bfloat16)
        got, want = tiled_block(xt, w, False), T.rdb5_bf16_reference(xt, w)
        assert rel_l2(got.float().numpy(), want.float().numpy()) < 2e-3   # sum order, bf16 flips


# -- the kernel's layouts, restated in numpy ------------------------------------

def stage_stream(quant):
    """(i, j, byte offset in stage i's weights, channels of source j, width of
    stage i) for every (stage, source) block of frag, and each stage's offset
    in frag: csrc/rdb5.cu::stage_off / src_off."""
    es = 1 if quant else 2
    blocks, stage_off, off = [], [], 0
    for i in range(5):
        stage_off.append(off)
        src = 0
        for j in range(i + 1):
            cj = 64 if j == 0 else 32
            blocks.append((i, j, src, cj, WIDTHS[i]))
            src += 9 * cj * es * WIDTHS[i]
        off += src
    return blocks, stage_off, off


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_fragment_order(case, quant):
    """frag, read the way the kernel reads it, gives back the per-source
    matrices.  A k-step (32 bytes of a pixel: 16 bf16 or 32 int8 values) of
    a tap is a block of width(i) * 32 bytes, [k half][n-group][row][16 bytes]:
    ldmatrix.x4 lane l gives the address of row l % 8 of matrix l / 8
    (matrices: (k half 0, group 2q), (half 1, 2q), (half 0, 2q + 1), (half 1,
    2q + 1)) and lane g*4 + t receives word t of row g of each, the mma.sync B
    fragment b0, b1 of two n-tiles; the wgmma descriptor names the same core
    matrices by LBO = width(i) / 8 * 128 bytes (between the halves of k) and
    SBO = 128 bytes (between n-groups)."""
    _, _, blk, _, absmax = case
    w = T.prep_int8(blk.convs(), torch.from_numpy(absmax)) if quant else T.prep_bf16(blk.convs())
    mats = [m.float().numpy() for m in (w.wq if quant else w.wsrc)]
    es = 1 if quant else 2
    e16 = 16 // es                      # values per 16 bytes
    flat = w.frag.view(torch.int8 if quant else torch.bfloat16).float().numpy()
    blocks, stage_off, total = stage_stream(quant)
    assert w.frag.dtype == torch.int32 and w.frag.numel() * 4 == total == 9 * 26624 * es
    for i, j, src, cj, ni in blocks:
        col0, ksteps, kb = sum(WIDTHS[j:i]), cj * es // 32, ni * 32
        base = stage_off[i] + src
        # ldmatrix: (tap, k-step, pair q, lane l) -> row address; the lane that
        # receives (register r, word t of row g) holds 4 bytes of it
        tap, ks, q, r, g, t, b = np.meshgrid(
            np.arange(9), np.arange(ksteps), np.arange(ni // 16), np.arange(4), np.arange(8),
            np.arange(4), np.arange(4 // es), indexing="ij")
        lane = r * 8 + g                                   # the lane that gave this row's address
        row = (((lane >> 3) & 1) * (ni // 8) + (lane >> 4)) * 8 + (lane & 7)
        addr = base + (tap * ksteps + ks) * kb + q * 256 + row * 16 + t * 4 + b * es
        half, ntile = r & 1, 2 * q + (r >> 1)             # b0/b1 of n-tile 2q, then of 2q + 1
        k = ks * 2 * e16 + half * e16 + t * (4 // es) + b  # the mma.sync B fragment's k
        want = mats[j][tap * cj + k, col0 + ntile * 8 + g]
        np.testing.assert_array_equal(flat[addr // es], want)
        # the descriptor: element (k, n) of a k-step's block
        tap, ks, k, n = np.meshgrid(np.arange(9), np.arange(ksteps), np.arange(2 * e16),
                                    np.arange(ni), indexing="ij")
        lbo, sbo = ni // 8 * 128, 128
        addr = (base + (tap * ksteps + ks) * kb + (k // e16) * lbo + (n // 8) * sbo
                + (n % 8) * 16 + (k % e16) * es)
        np.testing.assert_array_equal(flat[addr // es],
                                      mats[j][tap * cj + ks * 2 * e16 + k, col0 + n])


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_slices_cut_between_taps(quant):
    """The producer copies each stage's weights in slices of SLICE bytes (the
    last one short): no tap's block straddles a slice, every slice is a
    multiple of 16 bytes, and a tile takes 60 (bf16) or 32 (int8) of them."""
    blocks, stage_off, total = stage_stream(quant)
    es = 1 if quant else 2
    n_slices = 0
    for i in range(5):
        size = (stage_off[i + 1] if i < 4 else total) - stage_off[i]
        n_slices += -(-size // T.SLICE)
        assert stage_off[i] % 16 == 0 and size % 16 == 0
    assert n_slices == (32 if quant else 60)
    for i, j, src, cj, ni in blocks:
        tap_bytes = cj * es * ni
        for tap in range(9):
            lo = src + tap * tap_bytes
            assert lo // T.SLICE == (lo + tap_bytes - 1) // T.SLICE, (i, j, tap)


def tile_offsets(quant):
    """Byte offset of each source's tile in shared memory, and its pixel bytes
    and side: x on a (TILE + 2 HALO)^2 region, x_k on one k pixels smaller."""
    es, off, out = (1 if quant else 2), 0, []
    for j in range(5):
        side, pixb = T.TILE_H + 2 * (T.HALO - j), (64 if j == 0 else 32) * es
        out.append((off, pixb, side))
        off += side * side * pixb
    return out, off


def swz(off, pixb):
    """csrc/rdb5.cu::swz: where byte ``off`` of the tiles really lies."""
    return off ^ ((off >> 3) & ((pixb // 16 - 1) << 4))


@pytest.mark.parametrize("quant,j", [(False, 0), (False, 3), (True, 0), (True, 2)],
                         ids=["bf16-x", "bf16-x3", "int8-x", "int8-x2"])
def test_swizzle_is_conflict_free(quant, j):
    """The swizzle permutes the 16-byte pieces within each pixel; the eight
    row addresses of every ldmatrix matrix of an A fragment (8 consecutive
    pixels of a tile row, one 16-byte piece of a k-step, at any tap's shift)
    fall in eight different 16-byte columns of the banks; and the epilogue's
    stores of one instruction (8 pixels x 4 lanes x 4 bytes, or 2 bytes in
    int8) hit each bank at most once."""
    tiles, total = tile_offsets(quant)
    assert total == (100352 if quant else 200704)
    base, pixb, side = tiles[j]
    for p in range(side * side):
        lo = base + p * pixb
        assert sorted(swz(lo + c, pixb) for c in range(0, pixb, 16)) == list(
            range(lo, lo + pixb, 16))
    for y in range(0, side, 5):
        for x0 in range(side - 7):
            p0 = y * side + x0
            for piece in range(pixb // 16):        # (k-step, half) of the fragment
                rows = [swz(base + (p0 + r) * pixb + piece * 16, pixb) for r in range(8)]
                assert all(a % 16 == 0 for a in rows)
                assert len({(a >> 4) & 7 for a in rows}) == 8, (p0, piece)
    if j == 0:
        return                                     # x is written 16 bytes (4 in int8) at a time
    width = 2 if quant else 4                      # bytes a lane stores: channels c, c + 1
    for m0 in range(0, side * side - 7, 8):        # rows g = 0..7 of a slab half
        for ntile in range(32 // 8):
            banks = [swz(base + (m0 + g) * pixb + (ntile * 8 + 2 * t) * (width // 2), pixb) // 4
                     % 32 for g in range(8) for t in range(4)]
            assert max(banks.count(b) for b in set(banks)) <= (2 if quant else 1)


def bad_operands():
    _, _, blk, x, absmax = setup((1, 8, 128, 64))
    w8 = T.prep_int8(blk.convs(), torch.from_numpy(absmax))
    wb = T.prep_bf16(blk.convs())
    x32, x16 = torch.from_numpy(x), torch.from_numpy(x).to(torch.bfloat16)
    stride0 = w8._replace(sw=w8.sw[:1].expand(5, 64))
    return {
        "int8-takes-fp32": lambda: T.rdb5_int8_fused(x16, w8),
        "bf16-takes-bf16": lambda: T.rdb5_bf16_fused(x32, wb),
        "unsupported-width": lambda: T.rdb5_int8_fused(x32[:, :, :100], w8),
        "unsupported-height": lambda: T.rdb5_bf16_fused(x16[:, :4], wb),
        "stride-0-vector": lambda: T.rdb5_int8_fused(x32, stride0),
        "fragments-of-the-other-form": lambda: T.rdb5_int8_fused(x32, w8._replace(frag=wb.frag)),
        "float64-bias": lambda: T.rdb5_bf16_fused(x16, wb._replace(bias=wb.bias.double())),
        "requires-grad": lambda: T.rdb5_bf16_fused(x16.clone().requires_grad_(True), wb),
        "three-dims": lambda: T.rdb5_int8_fused(x32[0], w8),
    }


@pytest.mark.parametrize("name", ["int8-takes-fp32", "bf16-takes-bf16", "unsupported-width",
                                  "unsupported-height", "stride-0-vector",
                                  "fragments-of-the-other-form", "float64-bias",
                                  "requires-grad", "three-dims"])
def test_operand_checks_raise(name):
    with pytest.raises(ValueError, match="rdb5"):
        bad_operands()[name]()


def test_wrong_conv_shapes_raise(case):
    _, _, blk, _, _ = case
    convs = blk.convs()
    with pytest.raises(ValueError, match="conv2 weight"):
        T.prep_bf16([convs[0], convs[0], *convs[2:]])
