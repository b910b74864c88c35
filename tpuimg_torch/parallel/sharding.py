"""Data-parallel batches and row-sharded frames over a (data, sp) mesh of
devices (port of ``tpuimg.parallel.sharding``).

tpuimg runs these under ``jax.shard_map``: one controller drives every
device of a ``Mesh``. The port keeps the single controller: one Python
process drives a list of ``torch.device``s block by block, so no
``torch.distributed`` process group is needed (and NCCL refuses two ranks on
one card). The devices of a mesh may repeat, which JAX forbids: a mesh of
``[torch.device("cuda", 0)] * 4`` runs four row shards on one card, one after
another on its current stream, and ``[torch.device("cpu")] * 8`` runs the
kernels' plain versions.

- DP: a (B, H, W) batch splits over ``data`` (``shard_batch``).
- SP: one frame's rows split over ``sp`` (``shard_rows``). Stencils take a
  radius-deep halo from their neighbours (``_halo_exchange``: copies with
  ``.to(device, non_blocking=True)`` where tpuimg has ``lax.ppermute``), the
  integral a carry of the earlier shards' last rows, and the histogram ops
  a sum on the row's first device where tpuimg has ``psum``.

Every sharded op takes a global tensor (a NumPy array goes to the card, as
``core/device.py`` says) or a ``Sharded`` from ``shard_rows`` /
``shard_batch``, and returns a ``Sharded``: the result's blocks on their
mesh devices; ``Sharded.gather()`` assembles the global tensor. A single
(H, W) frame lives on the ``sp`` devices of the mesh's first data row
(shard_map would replicate it over ``data``, which one controller gains
nothing from). An H or B that does not divide over the mesh raises, as
shard_map does, except in ``clahe_sharded`` and ``enhance_sharded``, which
pad and crop as tpuimg does. No op synchronises with the host.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

from tpuimg_torch.core.borders import REFLECT101, REPLICATE, reflect101_index
from tpuimg_torch.core.device import as_image
from tpuimg_torch.core.validate import (
    DTypeError, ParamError, check_image, check_positive, check_radius,
    dtype_name)


@dataclass(frozen=True)
class Mesh:
    """``devices[d][s]``: the device at index d of ``data`` and s of
    ``sp``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "sp": len(self.devices[0])}


def make_mesh(n_data: int, n_sp: int, devices=None) -> Mesh:
    """(data, sp) mesh over the first n_data*n_sp devices; by default every
    visible CUDA device. An explicit list may repeat a device."""
    check_radius(n_data, name="n_data")
    check_radius(n_sp, name="n_sp")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_data * n_sp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[d * n_sp:(d + 1) * n_sp])
                      for d in range(n_data)))


@dataclass(frozen=True)
class Sharded:
    """A global tensor as blocks on a mesh: ``blocks[d][s]`` lies on
    ``mesh.devices[d][s]``.

    ``batch``: the leading dim splits over ``data`` (else ``blocks`` has the
    one data row of a single frame). The rows (dim -2) split over ``sp``, in
    order; the row blocks of an op that crops (uneven H in
    ``clahe_sharded``, ``enhance_sharded``) may be shorter at the end."""

    mesh: Mesh
    blocks: tuple[tuple[torch.Tensor, ...], ...]
    batch: bool

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (by default the first block's):
        the row blocks concatenated, then the data rows."""
        device = self.blocks[0][0].device if device is None else device
        parts = [torch.cat([b.to(device) for b in row], dim=-2)
                 for row in self.blocks]
        return torch.cat(parts, dim=0) if self.batch else parts[0]

    @property
    def ndim(self) -> int:
        return self.blocks[0][0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.blocks[0][0]
        lead = list(first.shape[:-2])
        if self.batch:
            lead[0] = sum(row[0].shape[0] for row in self.blocks)
        h = sum(b.shape[-2] for b in self.blocks[0])
        return (*lead, h, first.shape[-1])


def _spec(ndim: int) -> tuple:
    """tpuimg's default partitioning: the leading batch dim (if any) on
    ``data``, rows on ``sp``, columns whole."""
    if ndim == 2:
        return ("sp", None)
    return ("data", *([None] * (ndim - 3)), "sp", None)


def _row_bounds(h: int, n: int, uneven: bool) -> list[tuple[int, int]]:
    """The [start, stop) rows of each of n shards: h / n each, or, when
    ``uneven``, ceil(h / n) each with the last ones cut at h (maybe empty),
    the rows tpuimg's zero-padded shard_map blocks hold of the frame."""
    if not uneven and h % n:
        raise ValueError(
            f"{h} rows do not divide over the sp axis of {n} devices")
    hs = -(-h // n)
    return [(min(s * hs, h), min((s + 1) * hs, h)) for s in range(n)]


def _split(mesh: Mesh, x: torch.Tensor, uneven: bool = False):
    """x's blocks in ``_spec``'s layout: (n_data or 1) rows of n_sp row
    blocks, each contiguous on its device."""
    batch = _spec(x.ndim)[0] == "data"
    n_data, n_sp = mesh.shape["data"], mesh.shape["sp"]
    if batch and x.shape[0] % n_data:
        raise ValueError(
            f"a batch of {x.shape[0]} does not divide over the data axis of "
            f"{n_data} devices")
    bs = x.shape[0] // n_data if batch else 0
    bounds = _row_bounds(x.shape[-2], n_sp, uneven)
    out = []
    for d in range(n_data if batch else 1):
        part = x.narrow(0, d * bs, bs) if batch else x
        out.append(tuple(
            part.narrow(-2, lo, hi - lo).to(mesh.devices[d][s]).contiguous()
            for s, (lo, hi) in enumerate(bounds)))
    return tuple(out)


def _layout(mesh: Mesh, x, uneven: bool = False):
    """The blocks of ``x`` (a global tensor or array, or a ``Sharded``) in
    ``_spec``'s layout on ``mesh``: a ``Sharded`` already so laid out is
    taken as it is, anything else is split from the global tensor."""
    if isinstance(x, Sharded) and x.mesh == mesh and x.batch == (x.ndim > 2):
        return x.blocks
    x = x.gather() if isinstance(x, Sharded) else as_image(x)
    return _split(mesh, x, uneven)


def shard_batch(mesh: Mesh, batch) -> Sharded:
    """Place a (B, H, W) batch with B split over the ``data`` axis and each
    data row's frames split by rows over ``sp``, the layout every sharded
    op works in (tpuimg's P('data') replicates the frames over ``sp``,
    which one controller gains nothing from)."""
    batch = as_image(batch)
    if batch.ndim != 3:
        raise ValueError(
            f"shard_batch places a (B, H, W) batch; got ndim={batch.ndim}")
    return Sharded(mesh, _split(mesh, batch), batch=True)


def shard_rows(mesh: Mesh, img) -> Sharded:
    """Place one (H, W) frame with H split over the ``sp`` axis.

    2-D only: the sharded ops partition a leading dim over the ``data``
    axis (``_spec``), so use ``shard_batch`` for (B, H, W) batches."""
    img = as_image(img)
    if img.ndim != 2:
        raise ValueError(
            f"shard_rows places a single (H, W) frame; got ndim={img.ndim} "
            f"— use shard_batch for batched inputs")
    return Sharded(mesh, _split(mesh, img), batch=False)


def _edge_rows(block, radius: int, border: str, top: bool):
    """The ``radius`` rows the border policy puts above (``top``) or below
    a block: reflect-101 mirrored again past each edge (jnp.pad's map for
    any depth), replicate clamped. The index is built on the block's
    device, so the path copies nothing from host memory."""
    h = block.shape[-2]
    idx = torch.arange(-radius, 0, device=block.device) if top else (
        torch.arange(h, h + radius, device=block.device))
    idx = reflect101_index(idx, h) if border == REFLECT101 else idx.clamp(
        0, h - 1)
    return block.index_select(-2, idx)


def _halo_exchange(blocks, radius: int, border: str):
    """Pad each row shard of one data row with ``radius`` rows from its
    neighbours; the outer shards take the border policy's rows.

    Equivalent to padding the whole frame and then sharding, provided each
    shard holds >= radius rows (>= radius + 1 for reflect-101, whose
    full-frame pad reads rows 1..radius of the edge shard). A thinner shard
    would need a second neighbour's rows, so that raises."""
    if border not in (REFLECT101, REPLICATE):
        raise ParamError(
            f"border must be one of {[REFLECT101, REPLICATE]}, got {border!r}")
    n = len(blocks)
    min_rows = radius + 1 if border == REFLECT101 else radius
    thin = min(b.shape[-2] for b in blocks)
    if n > 1 and thin < min_rows:
        raise ValueError(
            f"row shard holds {thin} rows < {min_rows} (radius {radius}, "
            f"border {border!r}): halo exchange needs every shard to cover "
            f"the stencil reach (use fewer sp shards or a smaller radius)")
    out = []
    for s, b in enumerate(blocks):
        top = (_edge_rows(b, radius, border, True) if s == 0 else
               blocks[s - 1][..., -radius:, :].to(b.device, non_blocking=True))
        bot = (_edge_rows(b, radius, border, False) if s == n - 1 else
               blocks[s + 1][..., :radius, :].to(b.device, non_blocking=True))
        out.append(torch.cat([top, b, bot], dim=-2))
    return out


def _psum(parts, device):
    """The sum of same-shaped tensors on ``device``, in their dtype."""
    total = parts[0].to(device, non_blocking=True)
    for t in parts[1:]:
        total = total + t.to(device, non_blocking=True)
    return total


def _sharded(mesh: Mesh, blocks) -> Sharded:
    """The result of an op: row blocks in ``_spec``'s layout."""
    return Sharded(mesh, tuple(tuple(row) for row in blocks),
                   batch=blocks[0][0].ndim > 2)


def stencil_sharded(op, radius: int, border: str, mesh: Mesh):
    """Lift a local stencil op (a padded block in, the unpadded block out)
    to a row-sharded image via halo exchange.

    ``op(padded_block)`` must consume exactly ``radius`` halo rows on each
    side of the row axis: ``ops.gaussian.gaussian_ypadded`` or
    ``ops.morphology.morph_ypadded`` with their radius bound."""
    check_radius(radius)

    def run(img):
        blocks = _layout(mesh, img)
        return _sharded(mesh, [[op(p) for p in _halo_exchange(
            row, radius, border)] for row in blocks])

    return run


def integral_sharded(mesh: Mesh):
    """Row-sharded integral image with a cross-shard carry: the port's
    ``integral`` of each shard (the u8 scan kernel on the card), plus, on
    shard k, the sum of the earlier shards' last rows (the reference's
    tile-carry scan, Integral/integral_d.cu:504-593, at shard radix)."""
    from tpuimg_torch.ops.integral import integral

    def run(img):
        if not isinstance(img, Sharded):
            img = as_image(img)
        if img.dtype.is_floating_point:
            # the contract of ops.integral: an int cast would truncate a
            # [0, 1) float image to zeros
            raise DTypeError(
                f"integral_sharded is the uint8 -> int32 prefix sum; got "
                f"float dtype {dtype_name(img.dtype)}")
        out = []
        for row in _layout(mesh, img):
            local = [integral(b) for b in row]
            last = [x[..., -1:, :] for x in local]
            out.append([x if s == 0 else x + _psum(last[:s], x.device)
                        for s, x in enumerate(local)])
        return _sharded(mesh, out)

    return run


def guided_filter_sharded(mesh: Mesh, radius: int, eps: float,
                          self_guided: bool = False):
    """Row-sharded guided filter (reflect-101 fused-path semantics).

    The fused chain consumes a 2*radius halo: the windowed means of p, I,
    I*p, I*I need ``radius`` rows and the box means of a, b ``radius`` more.
    One halo exchange of 2r rows per input, then ``guided_ypadded`` on each
    shard.

    ``self_guided=True`` builds the p = I form: one halo exchange and the
    two-mean collapse; call the returned fn as ``run(I)``. Unflagged calls
    with ``p is I`` also take it."""
    from tpuimg_torch.ops.guided import guided_ypadded

    check_radius(radius)
    check_positive(eps, "eps")  # eps=0 gives 0/0=NaN on constant windows

    def run(I, p=None):
        if self_guided and p is not None and p is not I:
            raise ValueError(
                "guided_filter_sharded(self_guided=True) got a distinct "
                "source p — it would be silently ignored; build the op "
                "without self_guided for a separate guide/source pair")
        if not self_guided and p is None:
            # a forgotten source must not silently become the self-guided
            # filter, which gives plausible but wrong output
            raise TypeError(
                "guided_filter_sharded built without self_guided requires a "
                "source p; pass run(I, p) or build with self_guided=True")
        reach = 2 * radius
        Ib = _layout(mesh, I)
        if self_guided or p is I:
            out = [[guided_ypadded(x, x, radius, eps)
                    for x in _halo_exchange(row, reach, REFLECT101)]
                   for row in Ib]
        else:
            out = [[guided_ypadded(x, y, radius, eps) for x, y in zip(
                _halo_exchange(rI, reach, REFLECT101),
                _halo_exchange(rp, reach, REFLECT101))]
                for rI, rp in zip(Ib, _layout(mesh, p))]
        return _sharded(mesh, out)

    return run


def _partial_tile_hists(block, o: int, h: int, ytiles: int, xtiles: int,
                        th: int, tw: int, pad_top: int, pad_left: int):
    """(ytiles*xtiles, 256) int32: what the shard's frame rows o .. o +
    rows - 1 add to every tile histogram of the frame's centred reflect-101
    extension, plain PyTorch on the block's device (XLA in tpuimg). Each
    frame row lands on its own extension row and, near the top and bottom,
    on the pad row that mirrors it (extension row e is in y-tile e // th:
    dense grids on short frames have pads >= th). One scatter-add of every
    (tile, value) bin; ``bincount`` on the card would read its maximum back
    to the host."""
    dev = block.device
    rows, w = block.shape
    pad_right = xtiles * tw - w - pad_left
    pad_bot = ytiles * th - h - pad_top
    ext = torch.cat([block[:, 1:pad_left + 1].flip(1), block,
                     block[:, w - 1 - pad_right:w - 1].flip(1)], dim=1)
    # (first block row, stop, extension row of the first, step): the rows
    # themselves, those mirrored into the top pad (frame row g at
    # extension row pad_top - g) and into the bottom pad (at
    # pad_top + 2h - 2 - g)
    parts = [(0, rows, o + pad_top, 1)]
    lo, hi = max(1, o), min(pad_top, o + rows - 1)
    if lo <= hi:
        parts.append((lo - o, hi - o + 1, pad_top - lo, -1))
    lo, hi = max(h - 1 - pad_bot, o), min(h - 2, o + rows - 1)
    if lo <= hi:
        parts.append((lo - o, hi - o + 1, pad_top + 2 * h - 2 - lo, -1))
    col = torch.arange(xtiles * tw, device=dev) // tw * 256
    idx = []
    for a, b, e0, step in parts:
        e = e0 + step * torch.arange(b - a, device=dev)
        tile_row = (e // th * (xtiles * 256))[:, None]
        idx.append((ext[a:b].to(torch.int64) + col + tile_row).reshape(-1))
    idx = torch.cat(idx)
    counts = torch.zeros(ytiles * xtiles * 256, dtype=torch.int32, device=dev)
    counts.index_add_(0, idx, torch.ones(1, dtype=torch.int32,
                                         device=dev).expand(idx.numel()))
    return counts.reshape(-1, 256)


def clahe_sharded(mesh: Mesh, clip_limit: float, xtiles: int, ytiles: int):
    """Row-sharded CLAHE: each shard's weighted contributions to every tile
    histogram (the centred reflect-101 extension rows included, which the
    edge shards own the sources of), summed on the first ``sp`` device;
    clip/redistribute and the tables there, copied to every shard; then
    each shard's mapping through the ``clahe_band_map`` kernel at its global
    first row. Uneven H: the shards hold ceil(H / n) rows, the last ones
    fewer (tpuimg pads them with zero rows that count into no histogram and
    crops their mapping)."""
    from tpuimg_torch.kernels.lut import clahe_band_map
    from tpuimg_torch.ops.histogram import _clahe_geometry, _clahe_tables

    # the local op's parameter contract, failing at factory build
    check_radius(xtiles, name="xtiles")
    check_radius(ytiles, name="ytiles")
    check_positive(clip_limit, "clip_limit")

    def run(img):
        if not isinstance(img, Sharded):
            img = as_image(img)
        if img.ndim != 2:
            raise ValueError("clahe_sharded shards one (H, W) frame by rows")
        check_image(img, "img", dtypes=[torch.uint8])
        h, w = img.shape
        th, tw, pad_top, pad_left = _clahe_geometry(h, w, xtiles, ytiles)
        (blocks,) = _layout(mesh, img, uneven=True)
        # each shard's global first row
        starts = list(itertools.accumulate(
            [b.shape[0] for b in blocks[:-1]], initial=0))
        hists = _psum([_partial_tile_hists(b, o, h, ytiles, xtiles, th, tw,
                                           pad_top, pad_left)
                       for b, o in zip(blocks, starts) if b.shape[0]],
                      blocks[0].device)
        tables = _clahe_tables(hists, clip_limit, th, tw)
        return _sharded(mesh, [[
            clahe_band_map(b, tables.to(b.device, non_blocking=True), ytiles,
                           xtiles, th, tw, pad_top, pad_left, o)
            if b.shape[0] else b.clone() for b, o in zip(blocks, starts)]])

    return run


def enhance_sharded(mesh: Mesh, clip_limit: float = 2.0, tiles: int = 8,
                    radius: int = 2, sigma: float = 1.5, gf_radius: int = 8,
                    gf_eps: float = 1e-3):
    """Row-sharded enhance chain (``pipeline.enhance`` "staged" semantics):
    CLAHE -> gaussian denoise -> guided detail restore, over the ``sp``
    axis.

    The tail takes one halo exchange of depth ``2*gf_radius + radius``:
    ``gaussian_ypadded`` consumes ``radius`` halo rows and leaves
    ``2*gf_radius`` rows of smoothed pad for ``guided_ypadded``, exact at the
    outer shards because symmetric kernels commute with the reflect-101
    mirror.

    Uneven H: the frame is padded below with its reflect-101 extension to a
    shard multiple at least ``2*gf_radius + radius`` deep, so every kept row
    reads only true-extension values, and the pad rows are cropped."""
    from tpuimg_torch.ops.gaussian import gaussian_ypadded
    from tpuimg_torch.ops.guided import guided_ypadded
    from tpuimg_torch.pipeline import _to_u8

    check_radius(radius)
    check_radius(gf_radius, name="gf_radius")
    check_positive(sigma, "sigma")
    check_positive(gf_eps, "gf_eps")
    cl = clahe_sharded(mesh, clip_limit, tiles, tiles)
    n_sp = mesh.shape["sp"]
    reach = 2 * gf_radius + radius

    def run(img):
        if not isinstance(img, Sharded):
            img = as_image(img)
        if img.ndim != 2:
            raise ValueError("enhance_sharded shards one (H, W) frame by rows")
        check_image(img, "img", dtypes=[torch.uint8])
        h = img.shape[0]
        # u8 CLAHE, staged semantics (the inter-stage quantization)
        (eq,) = cl(img).blocks
        f = [b.to(torch.float32) * (1.0 / 255.0) for b in eq]
        hpad = 0
        if h % n_sp:
            hs = -(-(h + reach) // n_sp)  # pad depth >= reach (docstring)
            hpad = hs * n_sp - h
            if hpad > h - 1:
                raise ValueError(
                    f"enhance_sharded needs h-1 >= pad rows ({hpad}) to build "
                    f"the reflect-101 shard padding for H={h} over {n_sp} sp "
                    f"shards — use fewer shards or a shard-multiple H")
            whole = torch.cat([b.to(f[0].device, non_blocking=True)
                               for b in f])
            rows = reflect101_index(torch.arange(h + hpad,
                                                 device=whole.device), h)
            (f,) = _split(mesh, whole.index_select(0, rows))
        out = []
        for fp in _halo_exchange(f, reach, REFLECT101):
            smooth = gaussian_ypadded(fp, radius, sigma)
            Ip = fp[radius:fp.shape[-2] - radius]
            out.append(_to_u8(guided_ypadded(Ip, smooth, gf_radius, gf_eps)))
        if hpad:  # keep the frame's rows [0, h)
            hs = out[0].shape[0]
            out = [b[:max(0, min(hs, h - s * hs))] for s, b in enumerate(out)]
        return _sharded(mesh, [out])

    return run


def hist_equalize_sharded(mesh: Mesh):
    """Row-sharded global HE: per-shard (per-frame) histograms by the
    ``hist256`` kernel, summed over ``sp`` on the row's first device (the
    ``data`` axis is never reduced), the tables there, copied back, and the
    ``lut_gather`` kernel on each shard."""
    from tpuimg_torch.kernels.hist import hist256, hist256_frames
    from tpuimg_torch.kernels.lut import lut_gather, lut_gather_frames
    from tpuimg_torch.ops.histogram import _he_tables

    def run(img):
        if not isinstance(img, Sharded):
            img = as_image(img)
        check_image(img, "img", dtypes=[torch.uint8])
        if img.ndim > 3:
            # one histogram per leading index: (B1, B2, H, W) would fold
            # frames together
            raise ValueError(
                f"hist_equalize_sharded takes (H, W) or (B, H, W) inputs; "
                f"got ndim={img.ndim} — flatten leading batch dims to one")
        pixels = img.shape[-2] * img.shape[-1]
        batched = img.ndim == 3
        hist = hist256_frames if batched else hist256
        gather = lut_gather_frames if batched else lut_gather
        out = []
        for row in _layout(mesh, img):
            tables = _he_tables(_psum([hist(b) for b in row], row[0].device),
                                pixels)
            out.append([gather(tables.to(b.device, non_blocking=True), b)
                        for b in row])
        return _sharded(mesh, out)

    return run

