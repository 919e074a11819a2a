"""Kernel W1 (csrc/wta.cu, winner-take-all of both views) on the card,
bitwise against the plain wta_left and wta_right on the same card, NaN
equal to NaN: at the Cone (64x375x450) and KITTI (256x375x1242) sizes and
on a D-640 slab (640x64x2632); on the CPU emulation's cases
(tests/_wta_cases.py: D of 1, 2 and 3, W below D, min_disparity -4, 0
and 3, real_w below W, constant planes, exact ties at d and d + 1,
integer costs, columns whose right-view planes all lie outside the
image); on NaN cells; inside a CUDA graph capture. Also: match_device
launches W1 once and equals its plain pipeline, and a 2-rank
match_sharded (rows and disp layouts; discontinuity adjustment on padded
columns, where the volume is still masked for the refinement) launches it
once on each rank and equals its plain run (skips without 2 cards).

Needs a CUDA card and nvcc; skips without a card. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_wta_cuda.py
"""
import numpy as np
import pytest
import torch

from _wta_cases import CASES, volume
from adcensus_torch.config import LARGE_FLOAT, ADCensusOptions
from adcensus_torch.ops import _build
from adcensus_torch.stages import pipeline
from adcensus_torch.stages import wta as wta_stage
from adcensus_torch.synthetic import two_layer_pair
from chip_smoke import plain_versions

pytestmark = pytest.mark.cuda

# name -> (D, H, W, min_disparity, real_w (None: W)), on seeded uniform
# volumes
SIZES = {
    "cone": (64, 375, 450, 0, None),
    "kitti": (256, 375, 1242, 0, None),
    "d640_slab": (640, 64, 2632, 0, None),
    "kitti_min_d_neg": (256, 40, 1242, -4, None),
    "kitti_min_d_pos": (256, 40, 1242, 3, None),
    "slab_real_w": (640, 16, 2632, -4, 2601),
    "odd_w": (96, 33, 451, 0, 450),
}
# [sharded]: (label, image size, volume_axis, options); at 2 ranks 377x451
# pads one column
SHARDED = (("rows", (376, 450), "rows", {}),
           ("disp_padded", (377, 451), "disp", {}),
           ("rows_flags_padded", (377, 451), "rows",
            dict(exact_median=True, do_discontinuity_adjustment=True)))
SHARDED_D = 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_same(a, b):
    """Bitwise, with NaN equal to NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    assert torch.equal(a, b), f"differ at {int((a != b).sum())} cells"


def _plain(cost, opts, real_w):
    """The plain views on the volume masked beyond ``real_w``."""
    pad = torch.arange(cost.shape[2], device=cost.device) >= real_w
    vol = torch.where(pad, LARGE_FLOAT, cost)
    return wta_stage.wta_left(vol, opts), wta_stage.wta_right(vol, opts)


def _check(cost, min_d, real_w):
    d, _, w = cost.shape
    real_w = w if real_w is None else real_w
    opts = ADCensusOptions(min_disparity=min_d, max_disparity=min_d + d)
    _build.reset_launches()
    left, right = wta_stage.wta(cost, opts, real_w=real_w)
    assert _build.launches["wta"] == 1
    want_l, want_r = _plain(cost, opts, real_w)
    _assert_same(left, want_l)
    _assert_same(right, want_r)
    return left, right


@pytest.mark.parametrize("name", sorted(SIZES))
def test_wta_kernel_sizes(dev, name):
    d, h, w, min_d, real_w = SIZES[name]
    gen = torch.Generator(device=dev).manual_seed(d + h + w)
    cost = torch.rand((d, h, w), generator=gen, device=dev)
    left, _ = _check(cost, min_d, real_w)
    # winners fall inside the range: the parabola runs
    assert torch.isfinite(left).float().mean() > 0.9


@pytest.mark.parametrize("name", sorted(CASES))
def test_wta_kernel_edge_cases(dev, name):
    _, _, _, min_d, real_w, _ = CASES[name]
    _check(torch.as_tensor(volume(name), device=dev), min_d, real_w)


def test_wta_kernel_nan_cells(dev):
    """NaN cells: the left view takes the first, as argmin does on the
    card; the right view skips them."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cost = torch.rand((48, 30, 300), generator=gen, device=dev)
    cost[torch.rand(cost.shape, generator=gen, device=dev) < 0.02] = np.nan
    left, _ = _check(cost, -4, None)
    assert torch.isnan(left).any()


def test_wta_kernel_in_graph_capture(dev):
    """W1 allocates nothing itself and syncs nothing: captured in a CUDA
    graph, its replay gives the eager maps."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cost = torch.rand((64, 40, 300), generator=gen, device=dev)
    opts = ADCensusOptions(max_disparity=64)
    want = wta_stage.wta(cost, opts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = wta_stage.wta(cost, opts)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_match_device_launches_wta_once(dev):
    left, right, _ = two_layer_pair(375, 450, 16, 32, seed=0)
    opts = ADCensusOptions(max_disparity=64)
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, device=dev)
    torch.cuda.synchronize()
    assert _build.launches["wta"] == 1
    with plain_versions():
        _build.reset_launches()
        plain = pipeline.match_device(left, right, opts, device=dev)
        torch.cuda.synchronize()
        assert not any(_build.launches.values())
    _assert_same(disp, plain)


def _sharded_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the 2-rank test: each SHARDED case with the kernels
    (its launches counted) and on the plain versions, saved."""
    import torch.distributed as dist

    from adcensus_torch.parallel import distributed, sharded
    from adcensus_torch.parallel.mesh import make_mesh
    from adcensus_torch.stages import cost as cost_stage

    distributed.initialize(store, world, rank)
    try:
        dev = torch.device("cuda", rank)
        mesh = make_mesh(1, world)
        out = {}
        for label, (h, w), axis, extra in SHARDED:
            left, right, _ = two_layer_pair(h, w, 8, 20, seed=1)
            lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
            args = (lt, rt, cost_stage.compute_gray(lt),
                    cost_stage.compute_gray(rt),
                    ADCensusOptions(max_disparity=SHARDED_D, **extra), mesh,
                    "roll", axis)
            torch.cuda.synchronize()
            _build.reset_launches()
            disp = sharded.match_sharded(*args)
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            with plain_versions():
                plain = sharded.match_sharded(*args)
            out[label] = (disp.cpu(), plain.cpu(), launches)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_two_ranks_launch_wta_once(dev, tmp_path):
    """match_sharded on 2 cards, NCCL: W1 once on each rank, and every
    map bitwise the plain run's and the same on both ranks."""
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    _build.build()  # the ranks load the kernels
    mp.spawn(_sharded_rank, args=(2, (tmp_path / "store").as_uri(),
                                  str(tmp_path)), nprocs=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for label, (h, w), _, _ in SHARDED:
        for rank, got in enumerate(ranks):
            disp, plain, launches = got[label]
            assert launches["wta"] == 1, (label, rank)
            assert disp.shape == (h, w)
            _assert_same(disp, plain)
            _assert_same(disp, ranks[0][label][0])
