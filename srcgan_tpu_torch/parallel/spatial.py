"""The space axis: image rows cut into strips, one a rank, and the halo
exchanges that GSPMD derives in the JAX package for ``spatial_sharding``.

A **strip plan** (``plan_strips``) cuts the H rows of an NHWC batch into
contiguous strips, one per rank of the ``space`` line.  Strip boundaries are
multiples of the model's alignment (the product of the strides on its path:
16 at the ResDeconv colorizer's input, ``up`` at ``gray_degrade``'s), every
active strip is at least ``min_rows`` tall (the widest halo any unit must
give, so a neighbour two ranks away is never needed), the ragged rows go to
the last active strip, and a height too small for the mesh leaves trailing
ranks **empty**: they hold no rows, exchange nothing, and still join every
collective with zero counts.  With the boundaries aligned, every strided
convolution maps a strip onto exactly the whole image's output rows (the
last strip takes the ceil arithmetic of a ragged height).

``space_scope`` is a ``TorchFunctionMode`` under which the models run on a
strip unchanged:

- ``F.conv2d`` receives the rows its kernel, stride, padding and dilation
  need from the neighbours (``exchange``: an autograd function whose
  backward sends the halo gradients back and adds them into the edge rows),
  puts zero rows only at the image's true top and bottom, and convolves
  with no H padding.  Halos may be asymmetric: a 7x7/s2/p3 stem takes 3 rows
  from above and 2 from below.
- ``F.conv_transpose2d`` whose kernel is no taller than its stride (k2s2)
  and ``pixel_shuffle`` need no halo; a bilinear ``F.interpolate`` upsample
  takes one row each side (the image's edge rows repeated at its true
  edges); nearest upsampling and block-aligned downsampling are local.
- ``F.group_norm`` (the port's group and instance norm) and the train-mode
  batch norm (``ops.norm``) take their moments over the whole image: sums
  and element counts all-reduced, differentiably, over the space line (the
  batch norm over ``stats_group``, the data x space ranks in a 2-D step).
  Counts, not a mean of means: strips differ in height.

The fused units read their weights themselves, so the mode never sees
them.  Each exchanges its own halo once (``halo_unit``), runs on the
extended strip with the mode standing aside, and crops: the RDB5 kernel
takes 5 rows each side, the x4 tail kernel one trunk row each side and as
many more of the neighbour's rows as make the extended strip a multiple of
8 rows (never zero rows: they would not be zero after the tail's convs).
Where the extended strip fails a kernel's gate, the plain path runs through
the mode, as the single-device gate decides.

On a space line of one rank the strip is the whole image: the scope then
leaves every op as it is (and the batch norm's moments too, where the
``stats_group`` also has one rank), so a mesh of one computes what one
device computes.

A scope sums the bytes of the halo rows its strip received in the forward
exchanges (``SpaceScope.halo_bytes``), and the space-sharded predictors add
them to the counter ``space.halo_bytes`` once a call.  Modules that reduce
over the whole image in a way the mode does not all-reduce (RCAN's channel
attention) are refused by ``refuse_global_reductions``.

``gather_strips`` assembles the ranks' output strips on space rank 0; a
strip never gathers the whole image to compute what a halo should give it.
A scope holds for forwards in the thread that entered it; a backward that
recomputes a checkpointed forward in another thread would not see it, so
the steps refuse remat.
"""
from __future__ import annotations

import contextlib
import math
import threading
import warnings
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

_TL = threading.local()


class StripPlan:
    """Rows per rank of the space line at the plan's resolution."""

    def __init__(self, heights: Sequence[int]):
        self.heights = tuple(int(h) for h in heights)
        self.starts = tuple(sum(self.heights[:i]) for i in range(len(self.heights)))

    def active(self, i: int) -> bool:
        return self.heights[i] > 0

    def cut(self, a, i: int, dim: int = 1, scale: int = 1):
        """Strip i of ``a`` (numpy or tensor) along ``dim`` (H of NHWC by
        default), whose rows are ``scale`` times the plan's."""
        lo, n = self.starts[i] * scale, self.heights[i] * scale
        index = [slice(None)] * a.ndim
        index[dim] = slice(lo, lo + n)
        return a[tuple(index)]

    def __repr__(self):
        return f"StripPlan{self.heights}"


def plan_strips(h: int, ranks: int, align: int = 1, min_rows: int = 1) -> StripPlan:
    """Strips of ``h`` rows over ``ranks`` ranks: boundaries at multiples of
    ``align``, active strips at least ``min_rows`` tall, the blocks left over
    one each to the first strips, the ragged rows to the last active one,
    the ranks beyond what the height fills empty."""
    per = max(1, -(-min_rows // align))           # blocks a strip needs at least
    blocks = h // align
    active = min(ranks, blocks // per)
    if active == 0:
        return StripPlan([h] + [0] * (ranks - 1))
    base, extra = divmod(blocks, active)
    heights = [(base + (i < extra)) * align for i in range(active)]
    heights[-1] += h - blocks * align
    return StripPlan(heights + [0] * (ranks - active))


def _halo_of(k: int, s: int, p: int, d: int):
    """(rows from above, rows from below) a strip needs for a convolution
    whose boundaries sit at multiples of the stride s."""
    return p, max(0, d * (k - 1) - p - s + 1)


def geometry(model: nn.Module):
    """(alignment, least strip height) of ``model``'s input rows: the largest
    product of strides on its path (strided convolutions with kernels taller
    than one row; a transposed convolution divides it again), and the widest
    halo any convolution or fused unit takes, in input rows."""
    from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5
    from srcgan_tpu_torch.models.rddb import RDDBNet

    align, cum, rows = 1, 1, 1
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and m.kernel_size[0] > 1:
            p = m.padding[0] if isinstance(m.padding, tuple) else 0
            top, bottom = _halo_of(m.kernel_size[0], m.stride[0], p, m.dilation[0])
            rows = max(rows, max(top, bottom) * cum)
            cum *= m.stride[0]
            align = max(align, cum)
        elif isinstance(m, nn.ConvTranspose2d):
            cum = max(1, cum // m.stride[0])
        elif isinstance(m, ResidualDenseBlock5):
            rows = max(rows, 5)
        elif isinstance(m, RDDBNet) and m.upscale_factor == 4:
            rows = max(rows, 8)
    return align, max(rows, align)


def refuse_global_reductions(model: nn.Module, role: str) -> None:
    """Raise where ``model`` holds a module that reduces over the whole image
    in a way the mode does not all-reduce (``global_spatial_reduction``,
    e.g. RCAN's channel attention): on a strip it would take its own rows'
    mean and answer wrongly without an error."""
    for name, m in model.named_modules():
        if getattr(m, "global_spatial_reduction", False):
            raise ValueError(f"the {role}'s module {name} ({type(m).__name__}) reduces over "
                             "the whole image, which the space axis's strips do not "
                             "all-reduce: serve it on one device")


def cascade_geometry(sr_model: nn.Module, c_model: nn.Module, up: int):
    """(alignment, least strip height) in the SR input's rows for the
    cascade: the colorizer runs on rows ``up`` times as many."""
    a_sr, r_sr = geometry(sr_model)
    a_c, r_c = geometry(c_model)
    a_c = a_c // math.gcd(a_c, up)
    align = a_sr * a_c // math.gcd(a_sr, a_c)
    return align, max(r_sr, -(-r_c // up), align)


# -- the exchange -------------------------------------------------------------

def _p2p(ops):
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Exchange(torch.autograd.Function):
    """cat(top rows of the strip above, x, bottom rows of the strip below)
    along H of NCHW x; the backward returns the halo rows' gradients to
    their owners, which add them into their edge rows."""

    @staticmethod
    def forward(ctx, x, scope, top, bottom, give_up, give_down):
        ctx.scope, ctx.counts = scope, (top, bottom, give_up, give_down)
        n, c, h, w = x.shape
        if give_up > h or give_down > h:
            raise RuntimeError(f"a neighbour asked for {max(give_up, give_down)} halo rows "
                               f"of a strip of {h}: the strip plan is too fine for this model")
        new = lambda k: torch.empty((n, c, k, w), dtype=x.dtype, device=x.device)  # noqa: E731
        recv_top, recv_bottom = new(top), new(bottom)
        scope.halo_bytes += (recv_top.numel() + recv_bottom.numel()) * x.element_size()
        scope.transfer([("prev", x[:, :, :give_up]), ("next", x[:, :, h - give_down:])],
                       [("prev", recv_top), ("next", recv_bottom)])
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               and not x.is_contiguous() else torch.contiguous_format)
        return torch.cat([recv_top, x, recv_bottom], 2).contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, g):
        top, bottom, give_up, give_down = ctx.counts
        h = g.shape[2] - top - bottom
        gx = g[:, :, top:top + h].clone()
        n, c, _, w = g.shape
        back_up = torch.empty((n, c, give_up, w), dtype=g.dtype, device=g.device)
        back_down = torch.empty((n, c, give_down, w), dtype=g.dtype, device=g.device)
        ctx.scope.transfer([("prev", g[:, :, :top]), ("next", g[:, :, top + h:])],
                           [("prev", back_up), ("next", back_down)])
        if give_up:
            gx[:, :, :give_up] += back_up
        if give_down:
            gx[:, :, h - give_down:] += back_down
        return gx, None, None, None, None, None


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """A differentiable all-reduce SUM of ``t`` over ``group``."""
    from torch.distributed.nn import functional as dist_fn

    with warnings.catch_warnings():     # torch 2.13 marks the module as deprecated
        warnings.simplefilter("ignore", FutureWarning)
        return dist_fn.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def _in_graph(out: torch.Tensor, *params) -> torch.Tensor:
    """An empty strip's output, with the layer's parameters kept in the
    graph: an empty rank's gradients are zeros, not missing."""
    for p in params:
        if p is not None:
            out = out + (p.sum() * 0).to(out.dtype)
    return out


class SpaceScope(TorchFunctionMode):
    """The mode of one strip: ``group`` is the space line's process group,
    ``prev`` / ``next`` the global ranks of the active strips above and
    below (None at the image's true top and bottom, and on an empty rank),
    ``stats_group`` where the batch norm's moments are summed."""

    def __init__(self, group, prev: Optional[int], next_: Optional[int], active: bool,
                 stats_group=None):
        super().__init__()
        self.group, self.prev, self.next, self.active = group, prev, next_, active
        self.stats_group = group if stats_group is None else stats_group
        self.off = False
        # the bytes of the halo rows this strip received in the forward exchanges
        self.halo_bytes = 0
        # a strip that is the whole image (a line of one rank) has nothing to
        # exchange or sum: its forwards run as they would without a scope
        self.alone = group is not None and dist.get_world_size(group) == 1
        self.stats_alone = self.alone and dist.get_world_size(self.stats_group) == 1

    # -- units that exchange their own halo ------------------------------------

    @contextlib.contextmanager
    def paused(self):
        """The mode stands aside: the plain path of a unit that has exchanged
        its own halo must not exchange another."""
        off, self.off = self.off, True
        try:
            yield
        finally:
            self.off = off

    def exchange(self, x: torch.Tensor, top: int, bottom: int, give_up: Optional[int] = None,
                 give_down: Optional[int] = None) -> torch.Tensor:
        """NCHW x with ``top`` rows of the strip above and ``bottom`` of the
        strip below (none where there is no such strip).  ``give_up`` /
        ``give_down``: the rows the neighbours want of this strip; None asks
        them first (a small exchange of counts)."""
        top = top if self.prev is not None else 0
        bottom = bottom if self.next is not None else 0
        if give_up is None or give_down is None:
            want = torch.tensor([top, bottom], dtype=torch.int64, device=x.device)
            theirs = torch.zeros(2, dtype=torch.int64, device=x.device)
            self.transfer([("prev", want[:1]), ("next", want[1:])],
                          [("prev", theirs[:1]), ("next", theirs[1:])])
            # the rank above wants my first rows (its bottom halo), the rank below my last
            give_up, give_down = (int(v) for v in theirs.tolist())
        give_up = give_up if self.prev is not None else 0
        give_down = give_down if self.next is not None else 0
        if not (top or bottom or give_up or give_down):
            return x
        return _Exchange.apply(x, self, top, bottom, give_up, give_down)

    def halo_unit(self, x: torch.Tensor, top: int, bottom: int, fn: Callable,
                  out_scale: int = 1, nhwc: bool = False, symmetric: bool = False
                  ) -> torch.Tensor:
        """fn on x extended by ``top`` / ``bottom`` halo rows (exchanged
        once), with the mode standing aside, cropped back to x's rows (times
        ``out_scale``).  ``symmetric``: every strip takes the same halo, so
        the neighbours' wants need not be asked."""
        xc = to_nchw(x) if nhwc else x
        gives = (bottom, top) if symmetric else (None, None)
        ext = self.exchange(xc, top, bottom, *gives)
        got_top = top if self.prev is not None else 0
        with self.paused():
            y = fn(to_nhwc(ext) if nhwc else ext)
        return y.narrow(1 if nhwc else 2, got_top * out_scale, xc.shape[2] * out_scale)

    def tail_rows(self, h: int, multiple: int = 8):
        """(top, bottom) rows of a 1-row-halo unit whose extended strip must
        be a multiple of ``multiple`` rows: the extra rows come from the
        strip below, else from the one above; None where the strip has no
        neighbour to take them from."""
        top = 1 if self.prev is not None else 0
        bottom = 1 if self.next is not None else 0
        extra = -(h + top + bottom) % multiple
        if extra and self.next is not None:
            bottom += extra
        elif extra and self.prev is not None:
            top += extra
        elif extra:
            return None
        return top, bottom

    # -- the messages ------------------------------------------------------------

    def transfer(self, sends, recvs) -> None:
        """Send each (side, tensor) of ``sends`` to the strip on that side
        ("prev" or "next") and fill each (side, buffer) of ``recvs`` from
        it, in one batch; sides without a strip and empty tensors are
        skipped."""
        peers = {"prev": self.prev, "next": self.next}
        ops = [dist.P2POp(dist.isend, t.contiguous(), peers[side], self.group)
               for side, t in sends if peers[side] is not None and t.numel()]
        ops += [dist.P2POp(dist.irecv, b, peers[side], self.group)
                for side, b in recvs if peers[side] is not None and b.numel()]
        _p2p(ops)

    def total(self, t: torch.Tensor, stats: bool = False) -> torch.Tensor:
        """A differentiable sum of ``t`` over the strips (over ``stats_group``
        for the batch norm)."""
        return _sum_over(t, self.stats_group if stats else self.group)

    # -- the mode --------------------------------------------------------------

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not (self.off or self.alone):
            if func is F.conv2d:
                return self._conv2d(*args, **kwargs)
            if func is F.conv_transpose2d:
                return self._conv_transpose2d(*args, **kwargs)
            if func is F.group_norm:
                return self._group_norm(*args, **kwargs)
            if func is F.interpolate:
                return self._interpolate(*args, **kwargs)
        return func(*args, **kwargs)

    def _conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        pair = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v)  # noqa: E731
        (s, sw), (d, dw), k = pair(stride), pair(dilation), w.shape[2]
        if isinstance(padding, str):
            if padding == "valid":
                padding = 0
            elif s == 1 and (d * (k - 1)) % 2 == 0:
                padding = (d * (k - 1) // 2, dw * (w.shape[3] - 1) // 2)
            else:
                raise NotImplementedError(f"padding={padding!r} on a strip")
        p, pw = pair(padding)
        h = x.shape[2]
        if h == 0:
            wo = (x.shape[3] + 2 * pw - dw * (w.shape[3] - 1) - 1) // sw + 1
            out = torch.zeros((x.shape[0], w.shape[0], 0, wo), dtype=x.dtype, device=x.device)
            return _in_graph(out, x, w, b)
        if k == 1 and s == 1 and p == 0:
            return F.conv2d(x, w, b, stride, padding, dilation, groups)
        if self.next is not None and h % s:
            raise RuntimeError(f"a strip of {h} rows under a stride-{s} convolution: the "
                               "strip plan's alignment is too small for this model")
        top, bottom = _halo_of(k, s, p, d)
        x = self.exchange(x, top, bottom, give_up=bottom, give_down=top)
        pad_top = p if self.prev is None else 0
        pad_bottom = p if self.next is None else 0
        if pad_top or pad_bottom:
            x = F.pad(x, (0, 0, pad_top, pad_bottom))
        y = F.conv2d(x, w, b, (s, sw), (0, pw), (d, dw), groups)
        return y[:, :, :h // s] if self.next is not None else y

    def _conv_transpose2d(self, x, w, b=None, stride=1, padding=0, output_padding=0,
                          groups=1, dilation=1):
        pair = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v)  # noqa: E731
        (s, sw), (p, pw), (op, opw), (d, dw) = (pair(stride), pair(padding),
                                                pair(output_padding), pair(dilation))
        k = w.shape[2]
        if p or d * (k - 1) + 1 > s:
            raise NotImplementedError("a transposed convolution whose kernel overlaps its "
                                      "stride on a strip")
        if self.next is not None:
            op = s - d * (k - 1) - 1        # every input row owns s output rows
        if x.shape[2] == 0:
            wo = (x.shape[3] - 1) * sw - 2 * pw + dw * (w.shape[3] - 1) + opw + 1
            out = torch.zeros((x.shape[0], w.shape[1] * groups, 0, wo), dtype=x.dtype,
                              device=x.device)
            return _in_graph(out, x, w, b)
        return F.conv_transpose2d(x, w, b, (s, sw), (p, pw), (op, opw), groups, (d, dw))

    def _interpolate(self, x, size=None, scale_factor=None, mode="nearest",
                     align_corners=None, recompute_scale_factor=None, antialias=False):
        kw = dict(scale_factor=scale_factor, mode=mode, align_corners=align_corners,
                  recompute_scale_factor=recompute_scale_factor, antialias=antialias)
        fy = scale_factor[0] if isinstance(scale_factor, (tuple, list)) else scale_factor
        if size is not None or fy is None:
            raise NotImplementedError("F.interpolate to a size on a strip: give a scale factor")
        fy, h = float(fy), x.shape[2]
        # nearest upsampling, and either mode's block-aligned downsampling, stay in the strip
        if (mode == "nearest" and fy.is_integer()) or (
                mode in ("nearest", "bilinear") and fy < 1 and (1 / fy).is_integer()):
            return F.interpolate(x, **kw)
        if mode == "bilinear" and not align_corners and fy.is_integer() and h:
            r = int(fy)
            ext = self.exchange(x, 1, 1, give_up=1, give_down=1)
            edge_top = [x[:, :, :1]] if self.prev is None else []       # the true edges repeat
            edge_bottom = [x[:, :, -1:]] if self.next is None else []
            ext = torch.cat(edge_top + [ext] + edge_bottom, 2)
            return F.interpolate(ext, **kw)[:, :, r:r + h * r]
        raise NotImplementedError(f"F.interpolate mode={mode} x{fy} on a strip")

    def _group_norm(self, x, num_groups, weight=None, bias=None, eps=1e-5):
        n, c = x.shape[:2]
        xg = x.reshape(n, num_groups, -1)
        count = torch.full((1,), float(xg.shape[-1]), dtype=x.dtype, device=x.device)
        tot = self.total(torch.cat([xg.sum(-1).reshape(-1), count]))
        count = tot[-1].detach()
        mean = (tot[:-1] / count).view(n, num_groups, 1)
        dev = xg - mean
        var = self.total((dev * dev).sum(-1).reshape(-1)) / count
        y = (dev / torch.sqrt(var.view(n, num_groups, 1) + eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        if weight is not None:
            y = y * weight.view(shape)
        if bias is not None:
            y = y + bias.view(shape)
        return y

    def batch_moments(self, xf: torch.Tensor):
        """(mean, biased variance, count) per channel of NCHW xf over every
        strip of ``stats_group``: the train-mode batch norm's."""
        count = torch.full((1,), float(xf.numel() // max(xf.shape[1], 1)), dtype=xf.dtype,
                           device=xf.device)
        tot = self.total(torch.cat([xf.sum(dim=(0, 2, 3)), count]), stats=True)
        count = tot[-1].detach()
        mean = tot[:-1] / count
        dev = xf - mean.view(1, -1, 1, 1)
        var = self.total((dev * dev).sum(dim=(0, 2, 3)), stats=True) / count
        return mean, var, int(count.item())


def current() -> Optional[SpaceScope]:
    """The scope this thread runs a strip under, or None."""
    return getattr(_TL, "scope", None)


@contextlib.contextmanager
def space_scope(mesh, plan: StripPlan, axis: str = "space", stats_group=None):
    """Run the enclosed forwards as this rank's strip of ``plan`` on the
    mesh's ``axis`` line (see the module docstring)."""
    i, n = mesh.coord(axis), mesh.size(axis)
    if len(plan.heights) != n:
        raise ValueError(f"a plan of {len(plan.heights)} strips on a space axis of {n}")
    active = plan.active(i)
    prev = mesh.peer(axis, i - 1) if active and i > 0 else None
    nxt = mesh.peer(axis, i + 1) if active and i + 1 < n and plan.active(i + 1) else None
    with activate(SpaceScope(mesh.group(axis), prev, nxt, active, stats_group)) as scope:
        yield scope


@contextlib.contextmanager
def activate(scope: SpaceScope):
    """Run the enclosed forwards of this thread under ``scope``: its mode,
    and its moments for the train-mode batch norm (a process-wide hook)."""
    prev = current()
    _TL.scope = scope
    try:
        with scope, (contextlib.nullcontext() if scope.stats_alone
                     else norm.moments_by(scope.batch_moments)):
            yield scope
    finally:
        _TL.scope = prev


def gather_strips(y: torch.Tensor, mesh, axis: str = "space", dim: int = 2):
    """The ranks' strips of ``y`` (their rows along ``dim``; their other
    dims alike) concatenated on space rank 0; None on the other ranks."""
    i, n = mesh.coord(axis), mesh.size(axis)
    group = mesh.group(axis)
    shape = torch.tensor(list(y.shape), dtype=torch.int64, device=y.device)
    if i != 0:
        _p2p([dist.P2POp(dist.isend, shape, mesh.peer(axis, 0), group)])
        if y.shape[dim]:
            _p2p([dist.P2POp(dist.isend, y.contiguous(), mesh.peer(axis, 0), group)])
        return None
    parts: List[torch.Tensor] = [y]
    shapes = [torch.empty_like(shape) for _ in range(n - 1)]
    _p2p([dist.P2POp(dist.irecv, s, mesh.peer(axis, j + 1), group) for j, s in enumerate(shapes)])
    bufs = [(j, torch.empty(s.tolist(), dtype=y.dtype, device=y.device))
            for j, s in enumerate(shapes) if s[dim] > 0]
    _p2p([dist.P2POp(dist.irecv, b, mesh.peer(axis, j + 1), group) for j, b in bufs])
    parts += [b for _, b in bufs]
    return torch.cat(parts, dim)
