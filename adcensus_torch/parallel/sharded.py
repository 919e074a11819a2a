"""Sharded AD-Census pipeline over a (data, tile) mesh of ranks.

Port of ``adcensus_tpu/parallel/sharded.py``. JAX runs the per-shard body
under ``shard_map``; here each rank is one process with one device and
runs the same body SPMD, its collectives ``torch.distributed`` calls on
the mesh's ``tile`` (or ``data``) process group. The cost volume is
sharded over image rows on ``tile``, and pairs over ``data``:

* census, arms, support counts and the scanline's color distances are
  built cooperatively: each rank computes its own row (or column) slab
  from enough context rows, and all-gathers rebuild the full arrays;
* cost init, the horizontal scanline passes, WTA and the LR check are
  row-local;
* cross aggregation (kernel B1) and region voting (kernel B3) exchange a
  ``halo``-row halo with the row neighbours (``batch_isend_irecv``), then
  run on the haloed slab; arms never cross the image border, so the
  rank's own rows come out exactly as unsharded;
* the vertical scanline passes (kernel B2) run between two
  ``all_to_all_single`` reshards, rows to columns and back;
* interpolation (kernel B4) and the in-place median (kernel M1) run on
  the all-gathered map, the discontinuity adjustment (kernel M2) and the
  out-of-place median on a 1-row halo;
* images are padded to multiples of the tile count: the scanline's
  PAD/SEED step flags, the median's in-image mask and the padded
  columns' costs keep the real pixels as in the unpadded ``match_core``.

``volume_axis="disp"`` shards cost init and aggregation over d-plane
blocks instead (no halos), then one all-to-all reshards to rows for the
same tail. Every collective of a match runs on every rank of the group in
the same order, and nothing in the body reads the device from the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from adcensus_torch.config import (
    INVALID_FLOAT,
    LARGE_FLOAT,
    MAX_ARM_LENGTH,
    ADCensusOptions,
)
from adcensus_torch.ops.basic import check_cross_options, color_dist, shift2d
from adcensus_torch.ops.cross_matmul import (
    band_masks,
    cross_pass_matmul,
    vote_band_masks,
)
from adcensus_torch.ops.cross_sum import cross_pass
from adcensus_torch.ops.region_vote import region_vote_stats
from adcensus_torch.ops.scanline import scanline_pass
from adcensus_torch.stages import aggregate as agg_stage
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import refine as refine_stage
from adcensus_torch.stages import wta as wta_stage
from adcensus_torch.stages.pipeline import validate_inputs
from adcensus_torch.stages.scanline import _scan_flags, code_volume

VOLUME_AXES = ("rows", "disp")
# newer torch names all_gather_into_tensor all_gather_single (same
# arguments) and warns on the old name
_all_gather_base = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)


class _Shard(NamedTuple):
    """This rank's place in the tile group and the slab geometry: the
    (h, w) image is padded to (hp, wp); the rank owns rows [r0, r0 +
    h_local) and, between the vertical passes' reshards, columns [c0, c0
    + w_local)."""
    group: dist.ProcessGroup
    ranks: list
    n: int
    i: int
    h: int
    w: int
    hp: int
    wp: int
    h_local: int
    w_local: int
    r0: int
    c0: int
    halo: int


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_hw(x: torch.Tensor, hp: int, wp: int, fill) -> torch.Tensor:
    """``x`` (H, W, ...) padded with ``fill`` to (hp, wp, ...)."""
    h, w = x.shape[0], x.shape[1]
    out = x.new_full((hp, wp) + tuple(x.shape[2:]), fill)
    out[:h, :w] = x
    return out


def _pad_rows(x: torch.Tensor, top: int, bottom: int, fill=0) -> torch.Tensor:
    """``x`` with ``top`` and ``bottom`` rows of ``fill`` along dim 0."""
    rows = x.shape[0]
    out = x.new_full((top + rows + bottom,) + tuple(x.shape[1:]), fill)
    out[top : top + rows] = x
    return out


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: contiguous, bool as uint8."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _halo_rows(slab: torch.Tensor, halo: int, axis: int,
               sh: _Shard) -> torch.Tensor:
    """``slab`` with ``halo`` rows of the row-neighbour ranks of the tile
    group before and after it along ``axis`` (not wrapping: the first
    and last ranks receive zeros, which are always masked off because
    arms and windows never cross the image border). When the halo
    exceeds the slab's rows the exchange is multi-hop; each hop sends
    only the rows the receiver keeps. One rank pads with zeros."""
    if halo == 0:
        return slab
    rows = slab.shape[axis]
    if sh.n == 1:
        shape = list(slab.shape)
        shape[axis] = halo
        zeros = slab.new_zeros(shape)
        return torch.cat([zeros, slab, zeros], dim=axis)
    send = _wire(slab)
    hops = -(-halo // rows)
    ops, above, below = [], [], []
    for s in range(1, hops + 1):
        k = min(rows, halo - (s - 1) * rows)  # rows kept from hop s
        shape = list(send.shape)
        shape[axis] = k
        up = send.new_zeros(shape)    # the last k rows of rank i - s
        down = send.new_zeros(shape)  # the first k rows of rank i + s
        if sh.i - s >= 0:
            peer = sh.ranks[sh.i - s]
            ops.append(dist.P2POp(dist.irecv, up, peer, sh.group))
            ops.append(dist.P2POp(
                dist.isend, send.narrow(axis, 0, k).contiguous(), peer,
                sh.group))
        if sh.i + s < sh.n:
            peer = sh.ranks[sh.i + s]
            ops.append(dist.P2POp(
                dist.isend, send.narrow(axis, rows - k, k).contiguous(),
                peer, sh.group))
            ops.append(dist.P2POp(dist.irecv, down, peer, sh.group))
        above.append(up)
        below.append(down)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = torch.cat(above[::-1] + [send] + below, dim=axis)
    return out.to(torch.bool) if slab.dtype == torch.bool else out


def _all_gather(x: torch.Tensor, axis: int,
                group: dist.ProcessGroup) -> torch.Tensor:
    """The group's ``x`` concatenated along ``axis`` in rank order (JAX's
    tiled ``all_gather``)."""
    n = dist.get_world_size(group)
    send = _wire(x)
    # gathered along dim 0, which every backend takes, then moved
    out = send.new_empty((n * send.shape[0],) + tuple(send.shape[1:]))
    _all_gather_base(out, send, group=group)
    shape = list(send.shape)
    shape[axis] *= n
    out = out.view((n,) + tuple(send.shape)).movedim(0, axis).reshape(shape)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                group: dist.ProcessGroup) -> torch.Tensor:
    """Block j of ``x`` along ``split_axis`` goes to rank j; the blocks
    received are concatenated along ``concat_axis`` in rank order (JAX's
    tiled ``all_to_all``)."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _shard(mesh: DeviceMesh, h: int, w: int, opts: ADCensusOptions) -> _Shard:
    group = mesh.get_group("tile")
    n = dist.get_world_size(group)
    i = mesh.get_local_rank("tile")
    hp, wp = _ceil_to(h, n), _ceil_to(w, n)
    return _Shard(
        group=group, ranks=dist.get_process_group_ranks(group), n=n, i=i,
        h=h, w=w, hp=hp, wp=wp, h_local=hp // n, w_local=wp // n,
        r0=i * (hp // n), c0=i * (wp // n),
        halo=min(opts.cross_L1, MAX_ARM_LENGTH),
    )


def _precompute(left, right, gray_l, gray_r, opts: ADCensusOptions,
                sh: _Shard) -> dict:
    """Image-level arrays, built cooperatively and shared by both volume
    layouts: census from a 4-row context slab, arms from a ``halo``-row
    one (both in the image's coordinates), support counts from the
    gathered arms, the scanline's color distances of the x passes on own
    rows and of the y passes on own columns. Each rank builds its own
    slab; two all-gathers rebuild the full census, arms and support
    counts, and a third the full-width right-image y distances that the
    epipolar lookup reads. ``arms`` and ``sup_*`` carry ``halo`` extra
    rows top and bottom (arms 0, support 1), so a haloed row slab is a
    plain slice."""
    h, w, hp, wp, halo = sh.h, sh.w, sh.hp, sh.wp, sh.halo
    r0, c0, h_local, w_local = sh.r0, sh.c0, sh.h_local, sh.w_local
    dev = left.device
    left_p = _pad_hw(left, hp, wp, 0)
    right_p = _pad_hw(right, hp, wp, 0)

    def census_own(gray):
        ctx = _pad_rows(_pad_hw(gray, hp, wp, 0), 4, 4)
        slab = ctx[r0 : r0 + h_local + 8]
        cen = cost_stage.census_transform_9x7(
            slab, row_offset=r0 - 4, full_h=h, full_w=w
        )
        return cen[4 : 4 + h_local]

    # arms of own rows from a halo-row context slab; anchors outside the
    # image keep arms 0
    lslab = _pad_rows(left_p, halo, halo)[r0 : r0 + h_local + 2 * halo]
    arms_own = arms_stage.build_arms(
        lslab, opts, row_offset=r0 - halo, full_h=h, full_w=w
    )[halo : halo + h_local]
    gy = r0 + torch.arange(h_local, device=dev)
    row_valid = (gy < h)[:, None] & (torch.arange(wp, device=dev) < w)[None]
    arms_own = torch.where(row_valid[..., None], arms_own, 0)

    # gather 1: census (int64) and arms as one (6, hp, wp) int64 stack
    stack = _all_gather(torch.cat([
        census_own(gray_l)[None], census_own(gray_r)[None],
        arms_own.permute(2, 0, 1).to(torch.int64),
    ]), 1, sh.group)
    arms_full = stack[2:6].permute(1, 2, 0).to(torch.int32).contiguous()
    arms_pad = _pad_rows(arms_full, halo, halo)

    # gather 2: support counts of own rows from the gathered arms
    aslab = arms_pad[r0 : r0 + h_local + 2 * halo]
    sup_h, sup_v = agg_stage.support_counts(aslab, halo)
    own = slice(halo, halo + h_local)
    sup = _all_gather(torch.stack([sup_h[own], sup_v[own]]), 1, sh.group)

    # the scanline's color distances: x maps on own rows, y maps on own
    # columns (x shifts never cross rows, y shifts never cross columns);
    # padding is 0, as the unpadded images' zero fill reads
    col_valid = (torch.arange(hp, device=dev) < h)[:, None] & (
        c0 + torch.arange(w_local, device=dev) < w)[None]
    lrow, rrow = left_p[r0 : r0 + h_local], right_p[r0 : r0 + h_local]
    lcol, rcol = left_p[:, c0 : c0 + w_local], right_p[:, c0 : c0 + w_local]

    def dist_map(img, dy, dx, mask):
        return torch.where(mask, color_dist(img, shift2d(img, dy, dx, 0)), 0)

    dists, rd_y = {}, []
    for fw in (True, False):
        step = 1 if fw else -1
        dists[("x", fw)] = (dist_map(lrow, 0, step, row_valid),
                            dist_map(rrow, 0, step, row_valid))
        dists[("y", fw)] = dist_map(lcol, step, 0, col_valid)
        rd_y.append(dist_map(rcol, step, 0, col_valid))
    # gather 3: the y maps of the right image at full width
    rd_y = _all_gather(torch.stack(rd_y), 2, sh.group)
    for k, fw in enumerate((True, False)):
        dists[("y", fw)] = (dists[("y", fw)], rd_y[k])

    return dict(
        census_l=stack[0].contiguous(), census_r=stack[1].contiguous(),
        arms=arms_pad,
        sup_h=_pad_rows(sup[0], halo, halo, 1).to(torch.float32),
        sup_v=_pad_rows(sup[1], halo, halo, 1).to(torch.float32),
        left=left_p, right=right_p, dists=dists,
    )


def _aggregate(vol, arms, sup_h, sup_v, max_arm, cross_backend, keep=None):
    """4 cross-aggregation iterations of ``vol`` against the slab's arms
    and support counts (kernel B1, or band matrices built once). With
    ``keep``, the rank's ``_Shard``, ``vol`` is the rank's own rows: each
    iteration runs on them haloed by ``max_arm`` rows and keeps them."""
    masks = (band_masks(arms, max_arm) if cross_backend == "matmul"
             else None)
    horizontal_first = True
    for _ in range(4):
        slab = vol if keep is None else _halo_rows(vol, max_arm, 1, keep)
        args = (slab, arms, sup_h if horizontal_first else sup_v,
                horizontal_first, max_arm)
        if masks is None:
            out = cross_pass(*args, normalize=True)
        else:
            out = cross_pass_matmul(*args, normalize=True, masks=masks)
        vol = out if keep is None else out[
            :, max_arm : max_arm + keep.h_local].contiguous()
        horizontal_first = not horizontal_first
    return vol


def _pair_body(left, right, gray_l, gray_r, opts: ADCensusOptions,
               sh: _Shard, cross_backend: str) -> torch.Tensor:
    """One pair with the volume sharded over image rows end to end: this
    rank's (h_local, wp) rows of the disparity map."""
    pre = _precompute(left, right, gray_l, gray_r, opts, sh)
    r0, h_local, halo = sh.r0, sh.h_local, sh.halo
    own = slice(r0, r0 + h_local)
    vol = cost_stage.compute_cost_planes(
        pre["left"][own], pre["right"][own], pre["census_l"][own],
        pre["census_r"][own], opts, 0, opts.disp_range, real_w=sh.w,
    )  # (D, h_local, wp)
    # arms and support were padded with `halo` rows on both sides, so
    # the haloed slab is rows [r0 - halo, r0 + h_local + halo)
    halo_rows = slice(r0, r0 + h_local + 2 * halo)
    vol = _aggregate(vol, pre["arms"][halo_rows], pre["sup_h"][halo_rows],
                     pre["sup_v"][halo_rows], halo, cross_backend, keep=sh)
    return _tail_rows(vol, pre, opts, sh, cross_backend)


def _pair_body_disp(left, right, gray_l, gray_r, opts: ADCensusOptions,
                    sh: _Shard, cross_backend: str) -> torch.Tensor:
    """One pair with the volume sharded over the disparity axis through
    cost init and aggregation (no halos: aggregation never mixes
    planes), then one all-to-all to row blocks for the same tail as the
    rows layout. Each phase holds 1/n of the volume."""
    pre = _precompute(left, right, gray_l, gray_r, opts, sh)
    d_local = opts.disp_range // sh.n
    vol = cost_stage.compute_cost_planes(
        pre["left"], pre["right"], pre["census_l"], pre["census_r"], opts,
        sh.i * d_local, d_local, real_w=sh.w,
    )  # (d_local, hp, wp)
    image = slice(sh.halo, sh.halo + sh.hp)
    vol = _aggregate(vol, pre["arms"][image], pre["sup_h"][image],
                     pre["sup_v"][image], sh.halo, cross_backend)
    vol = _all_to_all(vol, 1, 0, sh.group)  # (D, h_local, wp)
    return _tail_rows(vol, pre, opts, sh, cross_backend)


def _scan(vol, code, opts, axis, forward, valid):
    """One scanline pass (kernel B2) with PAD steps where ``valid`` (in
    array order) is False."""
    flags = _scan_flags(valid.shape[0], valid if forward else valid.flip(0))
    return scanline_pass(vol, code, flags, opts.so_p1, opts.so_p2, axis,
                         reverse=not forward)


def _tail_rows(vol, pre, opts: ADCensusOptions, sh: _Shard,
               cross_backend: str) -> torch.Tensor:
    """Scanline, WTA and refinement of a row-sharded (D, h_local, wp)
    volume: this rank's (h_local, wp) disparity rows, +inf outside the
    image."""
    h, w, hp, wp, halo = sh.h, sh.w, sh.hp, sh.wp, sh.halo
    r0, h_local = sh.r0, sh.h_local
    dev = vol.device
    dists = pre["dists"]
    cols = torch.arange(wp, device=dev)

    # ---- scanline: x passes on own rows, y passes on own columns -------
    for fwd in (True, False):
        d1, rd = dists[("x", fwd)]
        vol = _scan(vol, code_volume(d1, rd, opts, w, 0), opts, "x",
                    fwd, cols < w)
    vol = _all_to_all(vol, 2, 1, sh.group)  # (D, hp, w_local)
    for fwd in (True, False):
        d1, rd = dists[("y", fwd)]
        vol = _scan(vol, code_volume(d1, rd, opts, w, sh.c0),
                    opts, "y", fwd, torch.arange(hp, device=dev) < h)
    vol = _all_to_all(vol, 1, 2, sh.group)  # (D, h_local, wp)

    # ---- WTA: pad columns behave like out-of-image ----------------------
    vol = torch.where((cols >= w)[None, None, :], LARGE_FLOAT, vol)
    disp_l = wta_stage.wta_left(vol, opts)
    disp_r = wta_stage.wta_right(vol, opts)

    # ---- refinement, gated as multistep_refine gates it -----------------
    row_ids = r0 + torch.arange(h_local, device=dev)
    in_image = (row_ids < h)[:, None] & (cols < w)[None]
    disp = disp_l
    occl = torch.zeros_like(in_image)
    mism = torch.zeros_like(in_image)
    if opts.do_lr_check:
        disp, occl, mism = refine_stage.outlier_detection(
            disp_l, disp_r, opts, real_w=w
        )
    disp = torch.where(in_image, disp, INVALID_FLOAT)
    occl = occl & in_image
    mism = mism & in_image

    if opts.do_filling:
        # voting on the haloed slab, so that regions crossing the slab's
        # edge see their whole support; no target in the halo rows
        arms = pre["arms"][r0 : r0 + h_local + 2 * halo]
        masks = (vote_band_masks(arms, halo) if cross_backend == "matmul"
                 else None)
        own = slice(halo, halo + h_local)
        for _ in range(5):
            for phase_mask in (mism, occl):
                target = phase_mask & ~torch.isfinite(disp)
                di, valid = refine_stage.vote_indices(
                    _halo_rows(disp, halo, 0, sh), opts)
                best, max_ht, count = region_vote_stats(
                    di, valid, arms, opts.disp_range, halo, cross_backend,
                    masks, target=_pad_rows(target, halo, halo, False),
                )
                disp = refine_stage.apply_vote_fill(
                    disp, target, best[own], max_ht[own], count[own], opts)

        # interpolation on the gathered map, at own rows' targets only
        def interp_phase(disp, target, is_mismatch):
            full = _all_gather(disp, 0, sh.group)
            fills = refine_stage.interpolation_fills(
                full, pre["left"], opts, is_mismatch,
                target=_pad_rows(target, r0, hp - r0 - h_local, False),
            )
            return torch.where(target, fills[r0 : r0 + h_local], disp)

        disp = interp_phase(disp, mism & ~torch.isfinite(disp), True)
        disp = interp_phase(disp, occl & ~torch.isfinite(disp), False)

    if opts.do_discontinuity_adjustment:
        # a 1-row halo of map and volume; the image's border rows and
        # columns keep their values, as edge_detect leaves them unsharded
        adj = refine_stage.depth_discontinuity_adjustment(
            _halo_rows(disp, 1, 0, sh), _halo_rows(vol, 1, 1, sh), opts,
        )[1 : 1 + h_local]
        interior = ((row_ids > 0) & (row_ids < h - 1))[:, None] & (
            (cols > 0) & (cols < w - 1))[None]
        disp = torch.where(interior, adj, disp)

    if opts.exact_median:
        # the in-place median is a raster-order wavefront over the whole
        # map: run it on the gathered map cropped to the image
        full = _all_gather(disp, 0, sh.group)[:h, :w]
        med = refine_stage.median_filter_3x3_inplace(full)
        disp = _pad_hw(med, hp, wp, INVALID_FLOAT)[r0 : r0 + h_local]
    else:
        disp = refine_stage.median_filter_3x3(
            _halo_rows(disp, 1, 0, sh), _halo_rows(in_image, 1, 0, sh),
        )[1 : 1 + h_local]
    return torch.where(in_image, disp, INVALID_FLOAT)


def _body(volume_axis: str, opts: ADCensusOptions, n_tile: int,
          cross_backend: str):
    """The per-rank body of ``volume_axis``, with its arguments checked
    before any collective."""
    check_cross_options(cross_backend)
    if volume_axis not in VOLUME_AXES:
        raise ValueError(f"unknown volume_axis {volume_axis!r}; expected "
                         f"one of {VOLUME_AXES}")
    if volume_axis == "disp" and opts.disp_range % n_tile:
        raise ValueError(
            f"disp_range {opts.disp_range} must be a multiple of the mesh "
            f"size {n_tile} for volume_axis='disp'"
        )
    return _pair_body if volume_axis == "rows" else _pair_body_disp


def match_sharded(
    left: torch.Tensor,
    right: torch.Tensor,
    gray_l: torch.Tensor,
    gray_r: torch.Tensor,
    opts: ADCensusOptions,
    mesh: DeviceMesh,
    cross_backend: str = "roll",
    volume_axis: str = "rows",
) -> torch.Tensor:
    """One pair over the mesh's ``tile`` dim, called on every rank of it
    with the same unpadded (H, W, 3) images and (H, W) uint8 grays on the
    rank's device. Returns the (H, W) float32 disparity on every rank,
    bitwise ``match_core``'s.

    ``volume_axis`` partitions the cost volume through cost init and
    aggregation: "rows" (a halo exchange an iteration) or "disp" (d-plane
    blocks; ``disp_range`` must be a multiple of the tile count). The
    scanline, WTA and refinement tail is row-sharded either way.
    ``cross_backend`` is "roll" (kernels B1 and B3) or "matmul" (band
    matrices, built on the haloed slabs)."""
    validate_inputs(left, right, opts)
    sh = _shard(mesh, left.shape[0], left.shape[1], opts)
    body = _body(volume_axis, opts, sh.n, cross_backend)
    own = body(left, right, gray_l, gray_r, opts, sh, cross_backend)
    return _all_gather(own, 0, sh.group)[: sh.h, : sh.w].contiguous()


def match_sharded_batched(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    grays_l: torch.Tensor,
    grays_r: torch.Tensor,
    opts: ADCensusOptions,
    mesh: DeviceMesh,
    cross_backend: str = "roll",
    volume_axis: str = "rows",
) -> torch.Tensor:
    """A batch of pairs over ``data``, each pair's volume over ``tile``:
    (B, H, W, 3) stacks and (B, H, W) grays, the same on every rank ->
    the (B, H, W) disparities on every rank. Data coordinate k takes
    pairs [k B / n_data, (k + 1) B / n_data) one after another; B must be
    a multiple of the ``data`` size. ``volume_axis`` as in
    ``match_sharded``."""
    b = lefts.shape[0]
    data = mesh.get_group("data")
    n_data = dist.get_world_size(data)
    if b % n_data:
        raise ValueError(f"batch {b} must be a multiple of the mesh's data "
                         f"size {n_data}")
    per = b // n_data
    k = mesh.get_local_rank("data")
    own = torch.stack([
        match_sharded(lefts[j], rights[j], grays_l[j], grays_r[j], opts,
                      mesh, cross_backend, volume_axis)
        for j in range(k * per, (k + 1) * per)
    ])
    return _all_gather(own, 0, data)

