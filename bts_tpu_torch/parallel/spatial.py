"""Spatial sharding (``--spatial_shards N``, ``--spatial_shards_w M``): one
image split into N x M bands over as many processes; counterpart of the
``model`` and ``model_w`` axes of ``bts_tpu/parallel/mesh.py``.

The JAX package lets GSPMD insert every halo exchange.  Here each process
holds one band of every activation and every window op of the model (conv,
pool, transposed conv) fetches the rows and columns of its input that its
band of the output needs, from the ranks that own them:

- **The layout.** ``world = D x N x M``: rank r is data group r // (N*M),
  band row i = (r // M) % N and band column j = r % M (:class:`Layout`).  The
  batch splits over the data groups; the N*M ranks of one group take the
  same rows and split each frame.
- **Ownership.** At a level of size n (the frame at H/s for s = 1 .. 32),
  band row i owns rows [i*n//N, (i+1)*n//N) (:func:`bounds`): even bands
  where N divides n, uneven ones (or empty) at H/16 and H/32, where it need
  not.  ``input_height/(8*N)`` an integer (the LPG check,
  ``ops/lpg.py::check_divisible``) keeps H, H/2, H/4 and H/8 cell-aligned.
- **Halos.** :meth:`Bands.window` returns the input rows and columns an
  op needs for this rank's output band: rows outside the frame hold the
  op's pad value (0, or -inf for max-pool), halos may be wider than a band
  (dense ASPP's dilation 24 at H/8), and rows go first, then columns, so
  the corners come along.  The backward (:class:`_Halo`) returns each
  halo's gradient to its owner, which adds it.
- **Order.** Every exchange is one ``all_to_all_single`` over the band's
  column group (rows) or row group (columns), which every rank of the group
  calls, the edge ranks included, in the same order in the forward, the
  backward and a remat recompute.
- **Transport.** NCCL carries the halos where each rank has its own card.
  gloo (``--device cpu``, or ranks that share a card) takes host tensors:
  a CUDA halo is then staged through pinned host memory.

:func:`use` makes a model's forward banded: the layers of
``models/layers.py`` consult :func:`current` and run whole tensors when it
is None, so a forward outside it (the visualisation forward and the online
eval of ``bts_main``) runs whole frames as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from bts_tpu_torch.ops.lpg import check_divisible

LEVELS = (1, 2, 4, 8, 16, 32)  # the pyramid's strides
HALO_BYTES = {"sent": 0}  # bytes this process sent in halo exchanges, forward and backward

_state = threading.local()  # .bands: the Bands of the forward running on this thread
_grid: Optional["Grid"] = None


def bounds(n: int, parts: int) -> List[int]:
    """The band boundaries of ``n`` rows over ``parts`` bands."""
    return [i * n // parts for i in range(parts + 1)]


@dataclass(frozen=True)
class Layout:
    """``world`` processes as (data, band row, band column) = (D, n, m)."""

    n: int
    m: int
    world: int

    @property
    def shards(self) -> int:
        return self.n * self.m

    @property
    def data(self) -> int:
        return self.world // self.shards

    def coords(self, rank: int) -> Tuple[int, int, int]:
        return rank // self.shards, (rank // self.m) % self.n, rank % self.m

    def rank(self, d: int, i: int, j: int) -> int:
        return d * self.shards + i * self.m + j


class Grid:
    """This rank's place in a :class:`Layout` and its process groups: the
    column group (band rows 0..n-1 of its column: the row exchanges), the
    row group (the column exchanges) and the spatial group (the n*m ranks
    of its data group).  Every rank makes every group, in one order, as
    ``dist.new_group`` requires; a group of one is None."""

    def __init__(self, layout: Layout, rank: int):
        self.layout = layout
        self.d, self.i, self.j = layout.coords(rank)
        self.col_group = self.row_group = self.spatial_group = None
        lay = layout
        for d in range(lay.data):
            for j in range(lay.m if lay.n > 1 else 0):
                g = dist.new_group([lay.rank(d, i, j) for i in range(lay.n)])
                if (d, j) == (self.d, self.j):
                    self.col_group = g
            for i in range(lay.n if lay.m > 1 else 0):
                g = dist.new_group([lay.rank(d, i, j) for j in range(lay.m)])
                if (d, i) == (self.d, self.i):
                    self.row_group = g
            g = dist.new_group([lay.rank(d, i, j) for i in range(lay.n) for j in range(lay.m)])
            if d == self.d:
                self.spatial_group = g
        self.owner = None  # the default group this grid was made in
        self.bands: Dict[Tuple[int, int], "Bands"] = {}

    @property
    def writer(self) -> bool:
        """The first band of its data group, which writes the gathered frames."""
        return self.i == 0 and self.j == 0


def check_world(n: int, m: int, world: int) -> None:
    """Raise, naming the flags, unless ``world`` processes hold D x N x M."""
    if world % (n * m):
        raise ValueError(
            f"--spatial_shards {n} --spatial_shards_w {m} split each frame over {n * m} processes, but the "
            f"world holds {world}: launch a multiple of {n * m} with python -m torch.distributed.run "
            f"--nproc_per_node {n * m} ...")


def init_grid(n: int, m: int, world: int) -> Optional[Grid]:
    """The grid of the initialised process group (``world`` processes, see
    :func:`check_world`) for N x M bands (None when n*m is 1), made once per
    group: a collective call."""
    global _grid
    check_world(n, m, world)
    if n * m == 1:
        _grid = None
        return None
    layout = Layout(n, m, world)
    if _grid is None or _grid.layout != layout or _grid.owner is not _default_group():
        _grid = Grid(layout, dist.get_rank())
        _grid.owner = _default_group()
    return _grid


def grid() -> Optional[Grid]:
    """The grid :func:`init_grid` made for the current process group, if any."""
    if _grid is not None and dist.is_initialized() and _grid.owner is _default_group():
        return _grid
    return None


def _default_group():
    return dist.distributed_c10d._get_default_group()


def current() -> Optional["Bands"]:
    """The bands of the banded forward running on this thread, or None."""
    return getattr(_state, "bands", None)


@contextlib.contextmanager
def use(bands: Optional["Bands"]):
    """Run the model's layers on ``bands`` (None: whole tensors)."""
    prev = current()
    _state.bands = bands
    try:
        yield
    finally:
        _state.bands = prev


def _need(spec: tuple, o0: int, o1: int) -> Tuple[int, int]:
    """The input range [g0, g1) an op needs for its output range [o0, o1).
    ``("win", span, stride, pad, pad_total)``: a window of ``span`` input
    rows (the dilated kernel) every ``stride`` rows from ``-pad`` over the
    input padded by ``pad_total`` rows in all; ``("up",)``: the nearest-2x
    upsample followed by a 3x3 SAME conv (the UpConv), which gives output
    rows [2*g0, 2*g1) of which [o0, o1) are whole."""
    if o0 == o1:
        return 0, 0
    if spec[0] == "up":
        return (o0 - 1) // 2, o1 // 2 + 1
    _, span, stride, pad, _ = spec
    return o0 * stride - pad, (o1 - 1) * stride - pad + span


def _out_size(spec: tuple, n: int) -> int:
    """The whole output's size along one axis of ``n`` input rows."""
    if spec[0] == "up":
        return 2 * n
    _, span, stride, _, total = spec
    return (n + total - span) // stride + 1


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (lo, lo)


class _Plan:
    """One exchange along one axis (``dim`` 2: rows, 3: columns) of a
    group: rank p of the group owns [b[p], b[p+1]) and needs ``needs[p]``;
    the result on rank p is rows needs[p] with the pad value outside
    [0, b[-1])."""

    def __init__(self, dim: int, b: List[int], me: int, needs: List[Tuple[int, int]], group):
        self.dim, self.me, self.group = dim, me, group
        owned = [(b[q], b[q + 1]) for q in range(len(b) - 1)]
        lo, hi = needs[me]
        # global rows: of my need owned by rank q, and of q's need that I own
        self.recv = [_overlap(needs[me], own) for own in owned]
        self.send = [_overlap(needs[q], owned[me]) for q in range(len(owned))]
        self.pad = (max(0, min(hi, 0) - lo), max(0, hi - max(lo, b[-1])))
        self.base = b[me]
        # whether any rank of the group sends anything: the same answer on every rank
        self.comm = any(r[1] > r[0] for p in range(len(owned)) for q in range(len(owned)) if p != q
                        for r in [_overlap(needs[q], owned[p])])

    def _rows(self, t, rng):
        if rng[1] == rng[0]:
            return t.narrow(self.dim, 0, 0)
        return t.narrow(self.dim, rng[0] - self.base, rng[1] - rng[0])

    def forward(self, x: torch.Tensor, value: float) -> torch.Tensor:
        got = self._exchange(x, [None if q == self.me else self._rows(x, r) for q, r in enumerate(self.send)],
                             [r[1] - r[0] for r in self.recv])
        shape = list(x.shape)

        def fill(n):
            shape[self.dim] = n
            return [x.new_full(shape, value)] if n else []

        pieces = [self._rows(x, r) if q == self.me else got[q]
                  for q, r in enumerate(self.recv) if r[1] > r[0]]
        pieces = fill(self.pad[0]) + pieces + fill(self.pad[1])
        if not pieces:
            shape[self.dim] = 0
            return x.new_empty(shape)
        return torch.cat(pieces, self.dim)

    def backward(self, g: torch.Tensor, x_shape) -> torch.Tensor:
        gx = g.new_zeros(x_shape)
        at, parts = self.pad[0], []
        for r in self.recv:
            parts.append(g.narrow(self.dim, at, r[1] - r[0]))
            at += r[1] - r[0]
        self._rows(gx, self.recv[self.me]).add_(parts[self.me])
        got = self._exchange(g, [None if q == self.me else p for q, p in enumerate(parts)],
                             [r[1] - r[0] for r in self.send])
        for q, r in enumerate(self.send):
            if q != self.me and r[1] > r[0]:
                self._rows(gx, r).add_(got[q])
        return gx

    def _exchange(self, like: torch.Tensor, out: list, in_rows: List[int]) -> list:
        """Send ``out[q]`` to rank q of the group and receive ``in_rows[q]``
        rows from it, as raw bytes through one all_to_all_single."""
        if not self.comm:
            return [None] * len(out)
        shape = list(like.shape)
        shape[self.dim] = 1
        row_bytes = like.element_size() * math.prod(shape)
        send = [o.contiguous().view(-1).view(torch.uint8) for o in out if o is not None]
        flat = torch.cat(send) if send else like.new_empty(0, dtype=torch.uint8)
        in_splits = [0 if o is None else o.numel() * like.element_size() for o in out]
        out_splits = [n * row_bytes if q != self.me else 0 for q, n in enumerate(in_rows)]
        HALO_BYTES["sent"] += flat.numel()
        recv = _all_to_all(flat, out_splits, in_splits, self.group)
        got = []
        for q, piece in enumerate(recv.split(out_splits)):
            shape[self.dim] = in_rows[q]
            got.append(None if q == self.me else piece.view(like.dtype).view(shape))
        return got


def _all_to_all(flat: torch.Tensor, out_splits, in_splits, group) -> torch.Tensor:
    """``all_to_all_single`` of uint8 buffers.  gloo takes host tensors: a
    CUDA buffer goes through pinned host memory there, explicitly."""
    if flat.is_cuda and dist.get_backend(group) != "nccl":
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        recv = torch.empty(sum(out_splits), dtype=torch.uint8, pin_memory=True)
        dist.all_to_all_single(recv, host, out_splits, in_splits, group=group)
        return recv.to(flat.device, non_blocking=True)
    recv = flat.new_empty(sum(out_splits))
    dist.all_to_all_single(recv, flat, out_splits, in_splits, group=group)
    return recv


class _Halo(torch.autograd.Function):
    """:meth:`_Plan.forward` with its backward: each halo's gradient goes
    back to the rank that owns those rows."""

    @staticmethod
    def forward(ctx, x, plan, value):
        ctx.plan, ctx.x_shape = plan, x.shape
        return plan.forward(x, value)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g.contiguous(), ctx.x_shape), None, None


class Bands:
    """The bands of an H x W frame over a :class:`Grid`, at every level of
    the pyramid.  A band tensor's level is read from its (rows, columns),
    which differ between the levels of one rank: checked here, and true
    unless the frame is so small that a band holds one pixel or none at
    H/16 (then it is refused)."""

    def __init__(self, grid: Grid, height: int, width: int):
        lay = grid.layout
        check_divisible(height, width, lay.n, lay.m)
        self.grid, self.height, self.width = grid, height, width
        self.sizes = {s: (-(-height // s), -(-width // s)) for s in LEVELS}
        self.rows = {s: bounds(self.sizes[s][0], lay.n) for s in LEVELS}
        self.cols = {s: bounds(self.sizes[s][1], lay.m) for s in LEVELS}
        self._level: Dict[Tuple[int, int], int] = {}
        for s in LEVELS:
            key = self.band_shape(s)
            if key in self._level:
                raise ValueError(f"bands of {height}x{width} over {lay.n}x{lay.m}: levels H/{self._level[key]} "
                                 f"and H/{s} give rank ({grid.i}, {grid.j}) the same {key} band")
            self._level[key] = s
        self._plans: dict = {}

    def band(self, s: int) -> Tuple[int, int, int, int]:
        """(r0, r1, c0, c1): this rank's rows and columns at level ``s``."""
        r, c, g = self.rows[s], self.cols[s], self.grid
        return r[g.i], r[g.i + 1], c[g.j], c[g.j + 1]

    def band_shape(self, s: int) -> Tuple[int, int]:
        r0, r1, c0, c1 = self.band(s)
        return r1 - r0, c1 - c0

    def level(self, x: torch.Tensor) -> int:
        key = (x.shape[-2], x.shape[-1])
        if key not in self._level:
            raise ValueError(f"a {tuple(x.shape)} tensor is no band of the {self.height}x{self.width} frame: "
                             f"bands {self._level}")
        return self._level[key]

    def cut(self, t: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
        """This rank's band of a whole frame (full resolution) along ``dims``."""
        r0, r1, c0, c1 = self.band(1)
        return t.narrow(dims[0], r0, r1 - r0).narrow(dims[1], c0, c1 - c0)

    def window(self, x: torch.Tensor, spec_h: tuple, spec_w: tuple, up: bool = False, value: float = 0.0):
        """The rows and columns of the whole tensor (``x`` is this rank's
        band of it) that an op of specs ``spec_h``/``spec_w`` (see
        :func:`_need`; stride 2, 1 or, with ``up``, the x2 upsample) needs
        for this rank's band of its output.  Returns the window and, per
        axis, (offset, length): the op's output on the window holds this
        rank's band at [offset, offset + length)."""
        s = self.level(x)
        stride = spec_h[2] if spec_h[0] == "win" else 1
        s_out = s // 2 if up else s * stride
        sizes = tuple(_out_size(spec, n) for spec, n in zip((spec_h, spec_w), self.sizes[s]))
        if sizes != self.sizes.get(s_out):
            raise ValueError(f"an op of {spec_h}, {spec_w} takes the {self.sizes[s]} level H/{s} to {sizes}, "
                             f"not to a level of the {self.height}x{self.width} frame's bands")
        plans = self._plans.get((s, spec_h, spec_w, up))
        if plans is None:
            plans = self._plans[(s, spec_h, spec_w, up)] = self._plan(s, s_out, spec_h, spec_w)
        r0, r1, c0, c1 = self.band(s_out)
        crops = [(o0 - 2 * _need(spec, o0, o1)[0] if up and o1 > o0 else 0, o1 - o0)
                 for spec, (o0, o1) in ((spec_h, (r0, r1)), (spec_w, (c0, c1)))]
        for plan in plans:  # rows first, then columns of the taller window: the corners come along
            x = _Halo.apply(x, plan, value)
        return x, crops[0], crops[1]

    def _plan(self, s, s_out, spec_h, spec_w):
        g, lay = self.grid, self.grid.layout
        rows, cols = self.rows[s_out], self.cols[s_out]
        need_rows = [_need(spec_h, rows[i], rows[i + 1]) for i in range(lay.n)]
        need_cols = [_need(spec_w, cols[j], cols[j + 1]) for j in range(lay.m)]
        return (_Plan(2, self.rows[s], g.i, need_rows, g.col_group),
                _Plan(3, self.cols[s], g.j, need_cols, g.row_group))

    def global_size(self, x: torch.Tensor) -> Tuple[int, int]:
        """The whole tensor's (rows, columns) at ``x``'s level."""
        return self.sizes[self.level(x)]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole frames (B, C, H, W) from every band (B, C, H/N, W/M) of
        the spatial group, on every rank of it (gloo: on the host)."""
        g = self.grid
        if dist.get_backend(g.spatial_group) != "nccl":
            t = t.cpu()
        parts = [torch.empty_like(t) for _ in range(g.layout.shards)]
        dist.all_gather(parts, t.contiguous(), group=g.spatial_group)
        lay = g.layout
        rows = [torch.cat([parts[i * lay.m + j] for j in range(lay.m)], -1) for i in range(lay.n)]
        return torch.cat(rows, -2)


def bands(g: Grid, height: int, width: int) -> Bands:
    """The :class:`Bands` of an H x W frame over ``g``, made once."""
    if (height, width) not in g.bands:
        g.bands[height, width] = Bands(g, height, width)
    return g.bands[height, width]
