"""Sharded AD-Census pipeline over a (data, tile) mesh of ranks.

Port of ``adcensus_tpu/parallel/sharded.py``. JAX runs the per-shard body
under ``shard_map``; here each rank is one process with one device and
runs the same body SPMD, its collectives ``torch.distributed`` calls on
the mesh's ``tile`` (or ``data``) process group. The cost volume is
sharded over image rows on ``tile``, and pairs over ``data``:

* census, arms, support counts and the scanline's color distances are
  built cooperatively: each rank computes its own row (or column) slab
  from enough context rows, and all-gathers rebuild the full arrays (the
  census only in the disp layout: a row slab's cost reads its own rows'
  census alone);
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

Each stage runs in one span named from ``profiling.STAGES``, in
``match_core``'s order: ``cost`` pads the images and holds the census of
own rows and the cost planes; ``arms`` the arms and their gather;
``aggregation`` the support counts and their gather, and the four cross
passes with their halos (in the disp layout also the reshard to rows);
``scanline`` the color distances, their gather and the four passes with
both reshards; ``wta``; ``refine``. Each collective runs in a span
``shard.<kind>`` (``COMM_KINDS``) inside the stage that calls it, but for
the final gather of the map, in the caller's span; ``comm_bytes`` counts
what each kind moves.
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
from adcensus_torch.stages.scanline import _scan_flags
from adcensus_torch.utils.profiling import (
    AGGREGATION, ARMS, COST, REFINE, SCANLINE, WTA, span,
)

VOLUME_AXES = ("rows", "disp")
# newer torch names all_gather_into_tensor all_gather_single (same
# arguments) and warns on the old name
_all_gather_base = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
# The collectives' kinds, each a span ``shard.<kind>``.
COMM_KINDS = ("broadcast", "halo", "all_gather", "all_to_all")
# Bytes this rank sent and received by kind of collective since the last
# reset_comm_bytes(), counted on the host from the tensors' sizes (never
# read from the device) and as the collective's meaning has it, not as
# its algorithm routes them: an all-gather sends the rank's block to and
# receives one from each of the n - 1 others, an all-to-all its n - 1
# blocks for others, a halo exchange its isends and irecvs; a broadcast's
# root sends to the n - 1 others, each of which receives once.
comm_bytes = {kind: {"sent": 0, "received": 0} for kind in COMM_KINDS}


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


def _count(kind: str, sent: int, received: int) -> None:
    comm_bytes[kind]["sent"] += sent
    comm_bytes[kind]["received"] += received


def reset_comm_bytes() -> None:
    for kind in comm_bytes.values():
        kind["sent"] = kind["received"] = 0


def _broadcast(x: torch.Tensor, group: dist.ProcessGroup) -> None:
    """``x`` of the group's first rank, in place on every rank of it."""
    with span("shard.broadcast"):
        n = dist.get_world_size(group)
        dist.broadcast(x, src=dist.get_process_group_ranks(group)[0],
                       group=group)
        root = dist.get_group_rank(group, dist.get_rank()) == 0
        _count("broadcast", (n - 1) * x.nbytes if root else 0,
               0 if root else x.nbytes)


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
    with span("shard.halo"):
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
        _count("halo",
               sum(op.tensor.nbytes for op in ops if op.op is dist.isend),
               sum(op.tensor.nbytes for op in ops if op.op is dist.irecv))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = torch.cat(above[::-1] + [send] + below, dim=axis)
        return out.to(torch.bool) if slab.dtype == torch.bool else out


def _all_gather(x: torch.Tensor, axis: int,
                group: dist.ProcessGroup) -> torch.Tensor:
    """The group's ``x`` concatenated along ``axis`` in rank order (JAX's
    tiled ``all_gather``)."""
    with span("shard.all_gather"):
        n = dist.get_world_size(group)
        send = _wire(x)
        # gathered along dim 0, which every backend takes, then moved
        out = send.new_empty((n * send.shape[0],) + tuple(send.shape[1:]))
        _all_gather_base(out, send, group=group)
        _count("all_gather", (n - 1) * send.nbytes, (n - 1) * send.nbytes)
        shape = list(send.shape)
        shape[axis] *= n
        out = out.view((n,) + tuple(send.shape)).movedim(0, axis).reshape(
            shape)
        return out.to(torch.bool) if x.dtype == torch.bool else out


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                group: dist.ProcessGroup) -> torch.Tensor:
    """Block j of ``x`` along ``split_axis`` goes to rank j; the blocks
    received are concatenated along ``concat_axis`` in rank order (JAX's
    tiled ``all_to_all``)."""
    with span("shard.all_to_all"):
        n = dist.get_world_size(group)
        send = torch.stack(x.chunk(n, dim=split_axis))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        block = send.nbytes // n
        _count("all_to_all", (n - 1) * block, (n - 1) * block)
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


def _row_valid(sh: _Shard, dev) -> torch.Tensor:
    """(h_local, wp): the rank's own rows' pixels that lie in the image."""
    gy = sh.r0 + torch.arange(sh.h_local, device=dev)
    return (gy < sh.h)[:, None] & (torch.arange(sh.wp, device=dev)
                                   < sh.w)[None]


def _census_own(gray, sh: _Shard) -> torch.Tensor:
    """The census of the rank's own rows, from a 4-row context slab in
    the image's coordinates."""
    ctx = _pad_rows(_pad_hw(gray, sh.hp, sh.wp, 0), 4, 4)
    slab = ctx[sh.r0 : sh.r0 + sh.h_local + 8]
    cen = cost_stage.census_transform_9x7(
        slab, row_offset=sh.r0 - 4, full_h=sh.h, full_w=sh.w
    )
    return cen[4 : 4 + sh.h_local]


def _arms(left_p, opts: ADCensusOptions, sh: _Shard) -> torch.Tensor:
    """The (hp + 2 halo, wp, 4) arms of the whole padded image, ``halo``
    rows of 0 top and bottom, so that a haloed row slab is a plain
    slice: each rank builds its own rows from a ``halo``-row context slab
    (anchors outside the image keep arms 0), and an all-gather rebuilds
    the rest."""
    halo, r0, h_local = sh.halo, sh.r0, sh.h_local
    lslab = _pad_rows(left_p, halo, halo)[r0 : r0 + h_local + 2 * halo]
    arms_own = arms_stage.build_arms(
        lslab, opts, row_offset=r0 - halo, full_h=sh.h, full_w=sh.w
    )[halo : halo + h_local]
    arms_own = torch.where(_row_valid(sh, left_p.device)[..., None],
                           arms_own, 0)
    arms_full = _all_gather(arms_own.permute(2, 0, 1), 1, sh.group)
    return _pad_rows(arms_full.permute(1, 2, 0).contiguous(), halo, halo)


def _support(arms, sh: _Shard):
    """(sup_h, sup_v): the support counts of the whole padded image as
    float32, ``halo`` rows of 1 top and bottom like ``arms``: each rank
    counts its own rows from the haloed slab of the gathered arms, and an
    all-gather rebuilds the rest."""
    halo = sh.halo
    sup_h, sup_v = agg_stage.support_counts(
        arms[sh.r0 : sh.r0 + sh.h_local + 2 * halo], halo)
    own = slice(halo, halo + sh.h_local)
    sup = _all_gather(torch.stack([sup_h[own], sup_v[own]]), 1, sh.group)
    return (_pad_rows(sup[0], halo, halo, 1).to(torch.float32),
            _pad_rows(sup[1], halo, halo, 1).to(torch.float32))


def _scan_dists(left_p, right_p, sh: _Shard) -> dict:
    """The scanline's color distances: the x passes' maps on own rows and
    the y passes' on own columns (x shifts never cross rows, y shifts
    never cross columns); padding is 0, as the unpadded images' zero fill
    reads. The y maps of the right image, which the epipolar lookup reads
    at any column, are all-gathered to full width."""
    c0, w_local = sh.c0, sh.w_local
    dev = left_p.device
    row_valid = _row_valid(sh, dev)
    col_valid = (torch.arange(sh.hp, device=dev) < sh.h)[:, None] & (
        c0 + torch.arange(w_local, device=dev) < sh.w)[None]
    own = slice(sh.r0, sh.r0 + sh.h_local)
    lrow, rrow = left_p[own], right_p[own]
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
    rd_y = _all_gather(torch.stack(rd_y), 2, sh.group)
    for k, fw in enumerate((True, False)):
        dists[("y", fw)] = (dists[("y", fw)], rd_y[k])
    return dists


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
    rank's (h_local, wp) rows of the disparity map. The cost of own rows
    reads own rows' census only, so the census is never gathered."""
    r0, h_local, halo = sh.r0, sh.h_local, sh.halo
    own = slice(r0, r0 + h_local)
    with span(COST):
        left_p = _pad_hw(left, sh.hp, sh.wp, 0)
        right_p = _pad_hw(right, sh.hp, sh.wp, 0)
        vol = cost_stage.compute_cost_planes(
            left_p[own], right_p[own], _census_own(gray_l, sh),
            _census_own(gray_r, sh), opts, 0, opts.disp_range, real_w=sh.w,
        )  # (D, h_local, wp)
    with span(ARMS):
        arms = _arms(left_p, opts, sh)
    with span(AGGREGATION):
        sup_h, sup_v = _support(arms, sh)
        # arms and support carry `halo` rows on both sides, so the haloed
        # slab is rows [r0 - halo, r0 + h_local + halo)
        halo_rows = slice(r0, r0 + h_local + 2 * halo)
        vol = _aggregate(vol, arms[halo_rows], sup_h[halo_rows],
                         sup_v[halo_rows], halo, cross_backend, keep=sh)
    return _tail_rows(vol, left_p, right_p, arms, opts, sh, cross_backend)


def _pair_body_disp(left, right, gray_l, gray_r, opts: ADCensusOptions,
                    sh: _Shard, cross_backend: str) -> torch.Tensor:
    """One pair with the volume sharded over the disparity axis through
    cost init and aggregation (no halos: aggregation never mixes
    planes), then one all-to-all to row blocks for the same tail as the
    rows layout. Each phase holds 1/n of the volume."""
    d_local = opts.disp_range // sh.n
    with span(COST):
        left_p = _pad_hw(left, sh.hp, sh.wp, 0)
        right_p = _pad_hw(right, sh.hp, sh.wp, 0)
        census = _all_gather(torch.stack(
            [_census_own(gray_l, sh), _census_own(gray_r, sh)]), 1, sh.group)
        vol = cost_stage.compute_cost_planes(
            left_p, right_p, census[0].contiguous(), census[1].contiguous(),
            opts, sh.i * d_local, d_local, real_w=sh.w,
        )  # (d_local, hp, wp)
    with span(ARMS):
        arms = _arms(left_p, opts, sh)
    with span(AGGREGATION):
        sup_h, sup_v = _support(arms, sh)
        image = slice(sh.halo, sh.halo + sh.hp)
        vol = _aggregate(vol, arms[image], sup_h[image], sup_v[image],
                         sh.halo, cross_backend)
        vol = _all_to_all(vol, 1, 0, sh.group)  # (D, h_local, wp)
    return _tail_rows(vol, left_p, right_p, arms, opts, sh, cross_backend)


def _scan(vol, dists, opts, axis, forward, valid, col0, real_w):
    """One scanline pass (kernel B2) with PAD steps where ``valid`` (in
    array order) is False; ``dists`` = (d1, rd) give the penalty codes of
    volume columns from column ``col0`` of an image ``real_w`` wide."""
    flags = _scan_flags(valid.shape[0], valid if forward else valid.flip(0))
    return scanline_pass(vol, *dists, flags, opts.so_tso, opts.so_p1,
                         opts.so_p2, axis, not forward, opts.min_disparity,
                         col0, real_w)


def _tail_rows(vol, left_p, right_p, arms, opts: ADCensusOptions,
               sh: _Shard, cross_backend: str) -> torch.Tensor:
    """Scanline, WTA and refinement of a row-sharded (D, h_local, wp)
    volume, given the padded images and the haloed arms of ``_arms``:
    this rank's (h_local, wp) disparity rows, +inf outside the image."""
    h, w, hp = sh.h, sh.w, sh.hp
    dev = vol.device
    cols = torch.arange(sh.wp, device=dev)

    # ---- scanline: x passes on own rows, y passes on own columns -------
    with span(SCANLINE):
        dists = _scan_dists(left_p, right_p, sh)
        for fwd in (True, False):
            vol = _scan(vol, dists[("x", fwd)], opts, "x", fwd, cols < w, 0,
                        w)
        vol = _all_to_all(vol, 2, 1, sh.group)  # (D, hp, w_local)
        for fwd in (True, False):
            vol = _scan(vol, dists[("y", fwd)], opts, "y", fwd,
                        torch.arange(hp, device=dev) < h, sh.c0, w)
        vol = _all_to_all(vol, 1, 2, sh.group)  # (D, h_local, wp)

    # ---- WTA: pad columns behave like out-of-image ----------------------
    with span(WTA):
        vol = torch.where((cols >= w)[None, None, :], LARGE_FLOAT, vol)
        disp_l = wta_stage.wta_left(vol, opts)
        disp_r = wta_stage.wta_right(vol, opts)
    with span(REFINE):
        return _refine_rows(disp_l, disp_r, vol, left_p, arms, opts, sh,
                            cross_backend)


def _refine_rows(disp_l, disp_r, vol, left_p, arms, opts: ADCensusOptions,
                 sh: _Shard, cross_backend: str) -> torch.Tensor:
    """The refinement of ``_tail_rows``: this rank's disparity rows."""
    h, w, hp, wp, halo = sh.h, sh.w, sh.hp, sh.wp, sh.halo
    r0, h_local = sh.r0, sh.h_local
    dev = vol.device
    cols = torch.arange(wp, device=dev)

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
        arms = arms[r0 : r0 + h_local + 2 * halo]
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
                full, left_p, opts, is_mismatch,
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

