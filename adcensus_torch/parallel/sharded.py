"""Sharded AD-Census pipeline over a (data, tile) mesh of ranks.

Port of ``adcensus_tpu/parallel/sharded.py``. JAX runs the per-shard body
under ``shard_map``; here each rank is one process with one device and
runs the same body SPMD, its collectives ``torch.distributed`` calls on
the mesh's ``tile`` (or ``data``) process group. The cost volume is
sharded over image rows on ``tile``, and pairs over ``data``.

This module holds what exists because of sharding: the collectives, the
slab geometry (``_Shard``, padding), the census, arms, support counts and
color distances built across ranks, and the reshards. The stages run the one-card path's own code on the rank's row
slab (``_Shard`` is a ``stages/slab.py:Slab``):

* census, arms, support counts and the scanline's color distances are
  built cooperatively: each rank computes its own row (or column) slab
  from enough context rows, and all-gathers rebuild the full arrays (the
  census only in the disp layout: a row slab's cost reads its own rows'
  census alone);
* cost init, WTA and the LR check are row-local;
* ``aggregate`` (kernel B1) and the voting of ``multistep_refine``
  (kernel B3) run on the slab haloed by ``max_arm`` rows of the row
  neighbours (``batch_isend_irecv``) and keep the own rows, exactly as
  unsharded, since arms never cross the image border; interpolation
  (kernel B4) and the in-place median (kernel M1) run on the gathered
  map, the discontinuity adjustment (kernel M2) and the out-of-place
  median on a 1-row halo;
* the vertical ``scanline_pass``es (kernel B2) run between two
  ``all_to_all_single`` reshards, rows to columns and back;
* images are padded to multiples of the tile count: the scanline's
  PAD/SEED step flags, the slab's in-image mask and the padded columns'
  costs keep the real pixels as in the unpadded ``match_core``.

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

import dataclasses
import functools

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
from adcensus_torch.stages import aggregate as agg_stage
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import refine as refine_stage
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.stages import wta as wta_stage
from adcensus_torch.stages.pipeline import validate_inputs
from adcensus_torch.stages.slab import Slab
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


@dataclasses.dataclass
class _Shard(Slab):
    """This rank's place in the tile group and the slab geometry: the
    (h, w) image is padded to (hp, wp); the rank owns rows [r0, r0 +
    h_local) and, between the vertical passes' reshards, columns [c0, c0
    + w_local). As a ``Slab``, its own rows: halos from the row
    neighbours, the map gathered over the tile group."""
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
    max_arm: int
    dev: torch.device

    @property
    def real_w(self) -> int:
        return self.w

    @functools.cached_property
    def coords(self):
        """(image rows of the own rows, padded columns)."""
        return (self.r0 + torch.arange(self.h_local, device=self.dev),
                torch.arange(self.wp, device=self.dev))

    @functools.cached_property
    def in_image(self) -> torch.Tensor:
        """(h_local, wp): the own rows' pixels that lie in the image."""
        rows, cols = self.coords
        return (rows < self.h)[:, None] & (cols < self.w)[None]

    def halo(self, x, rows, axis=0):
        return _halo_rows(x, rows, axis, self)

    def pad(self, x, rows):
        return _pad_rows(x, rows, rows, False)

    def own(self, x, rows, axis=0):
        return x.narrow(axis, rows, self.h_local).contiguous()

    def gather(self, x):
        return _all_gather(x, 0, self.group)

    def place(self, x):
        return _pad_rows(x, self.r0, self.hp - self.r0 - self.h_local, False)

    def scatter(self, full):
        if tuple(full.shape) != (self.hp, self.wp):
            full = _pad_hw(full, self.hp, self.wp, INVALID_FLOAT)
        return full[self.r0 : self.r0 + self.h_local]

    def crop(self, full):
        return full[: self.h, : self.w]

    def mask(self, x, fill):
        if x.dtype == torch.bool:
            return x & self.in_image
        return torch.where(self.in_image, x, fill)

    def interior(self, new, old):
        rows, cols = self.coords
        inside = ((rows > 0) & (rows < self.h - 1))[:, None] & (
            (cols > 0) & (cols < self.w - 1))[None]
        return torch.where(inside, new, old)


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


def _shard(mesh: DeviceMesh, h: int, w: int, opts: ADCensusOptions,
           dev) -> _Shard:
    group = mesh.get_group("tile")
    n = dist.get_world_size(group)
    i = mesh.get_local_rank("tile")
    hp, wp = _ceil_to(h, n), _ceil_to(w, n)
    return _Shard(
        group=group, ranks=dist.get_process_group_ranks(group), n=n, i=i,
        h=h, w=w, hp=hp, wp=wp, h_local=hp // n, w_local=wp // n,
        r0=i * (hp // n), c0=i * (wp // n),
        max_arm=min(opts.cross_L1, MAX_ARM_LENGTH), dev=dev,
    )


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
    halo, r0, h_local = sh.max_arm, sh.r0, sh.h_local
    lslab = _pad_rows(left_p, halo, halo)[r0 : r0 + h_local + 2 * halo]
    arms_own = arms_stage.build_arms(
        lslab, opts, row_offset=r0 - halo, full_h=sh.h, full_w=sh.w
    )[halo : halo + h_local]
    arms_own = torch.where(sh.in_image[..., None], arms_own, 0)
    arms_full = _all_gather(arms_own.permute(2, 0, 1), 1, sh.group)
    return _pad_rows(arms_full.permute(1, 2, 0).contiguous(), halo, halo)


def _support(arms, sh: _Shard):
    """(sup_h, sup_v): the support counts of the whole padded image as
    float32, ``halo`` rows of 1 top and bottom like ``arms``: each rank
    counts its own rows from the haloed slab of the gathered arms, and an
    all-gather rebuilds the rest."""
    halo = sh.max_arm
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
    row_valid = sh.in_image
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


def _pair_body(left, right, gray_l, gray_r, opts: ADCensusOptions,
               sh: _Shard, cross_backend: str) -> torch.Tensor:
    """One pair with the volume sharded over image rows end to end: this
    rank's (h_local, wp) rows of the disparity map. The cost of own rows
    reads own rows' census only, so the census is never gathered."""
    r0, h_local, halo = sh.r0, sh.h_local, sh.max_arm
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
        vol = agg_stage.aggregate(
            vol, arms[halo_rows], opts, cross_backend=cross_backend,
            support=(sup_h[halo_rows], sup_v[halo_rows]), slab=sh)
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
        image = slice(sh.max_arm, sh.max_arm + sh.hp)
        vol = agg_stage.aggregate(vol, arms[image], opts,
                                  cross_backend=cross_backend,
                                  support=(sup_h[image], sup_v[image]))
        vol = _all_to_all(vol, 1, 0, sh.group)  # (D, h_local, wp)
    return _tail_rows(vol, left_p, right_p, arms, opts, sh, cross_backend)


def _tail_rows(vol, left_p, right_p, arms, opts: ADCensusOptions,
               sh: _Shard, cross_backend: str) -> torch.Tensor:
    """Scanline, WTA and refinement of a row-sharded (D, h_local, wp)
    volume, given the padded images and the haloed arms of ``_arms``:
    this rank's (h_local, wp) disparity rows, +inf outside the image."""
    w, hp = sh.w, sh.hp
    cols = sh.coords[1]

    # ---- scanline: x passes on own rows, y passes on own columns -------
    with span(SCANLINE):
        dists = _scan_dists(left_p, right_p, sh)
        for fwd in (True, False):
            vol = scan_stage.scanline_pass(vol, dists[("x", fwd)], opts, "x",
                                           fwd, cols < w, 0, w)
        vol = _all_to_all(vol, 2, 1, sh.group)  # (D, hp, w_local)
        for fwd in (True, False):
            vol = scan_stage.scanline_pass(
                vol, dists[("y", fwd)], opts, "y", fwd,
                torch.arange(hp, device=sh.dev) < sh.h, sh.c0, w)
        vol = _all_to_all(vol, 1, 2, sh.group)  # (D, h_local, wp)

    # ---- WTA: pad columns behave like out-of-image ----------------------
    with span(WTA):
        vol = torch.where((cols >= w)[None, None, :], LARGE_FLOAT, vol)
        disp_l = wta_stage.wta_left(vol, opts)
        disp_r = wta_stage.wta_right(vol, opts)
    with span(REFINE):
        return refine_stage.multistep_refine(
            disp_l, disp_r, left_p, vol,
            arms[sh.r0 : sh.r0 + sh.h_local + 2 * sh.max_arm], opts,
            cross_backend, sh,
        )["final"]


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
    sh = _shard(mesh, left.shape[0], left.shape[1], opts, left.device)
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

