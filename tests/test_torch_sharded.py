"""The port's sharded layer (adcensus_torch/parallel/), rows layout, on
the CPU: ranks spawned over gloo at 2 and 4 (tests/_sharded_cases.py).
Every case is bitwise the port's own match_core and the same on every
rank; the layout meets test_torch_pipeline.py's tolerance against JAX's
match_sharded on a mesh of the same tile count; a world of one runs in
this process; initialize checks its arguments before any process group
exists. The disp layout and the batched call are
tests/test_torch_sharded_disp.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _sharded_cases as cases
from adcensus_torch.parallel import distributed, sharded
from adcensus_torch.parallel.mesh import make_mesh
from adcensus_torch.stages import pipeline
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.parallel import mesh as jax_mesh
from adcensus_tpu.parallel import sharded as jax_sharded

ROWS = ["rows", "rows_odd", "rows_multi_hop", "rows_negative_min",
        "rows_flags", "rows_matmul"]
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's results of the ROWS cases."""
    return {world: cases.run(world, ROWS, tmp_path_factory.mktemp("store"))
            for world in WORLDS}


def core(name: str) -> np.ndarray:
    """The port's match_core on each of the case's pairs, (B, H, W)."""
    stacks = [torch.as_tensor(a) for a in cases.pairs(name)]
    backend = cases.CASES[name][3]
    return np.stack([
        pipeline.match_core(*(s[b] for s in stacks), cases.options(name),
                            cross_backend=backend)["disparity"].numpy()
        for b in range(stacks[0].shape[0])
    ])


def assert_ranks_bitwise(outs, ref):
    """Every rank's output is ``ref`` bit for bit."""
    for rank, out in enumerate(outs):
        assert isinstance(out, torch.Tensor), f"rank {rank}: {out}"
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      ref.view(np.uint32),
                                      err_msg=f"rank {rank}")


def assert_close_to_jax(ours, ref):
    """test_torch_pipeline.py's tolerance: validity agrees on >= 99 % of
    pixels, and >= 99 % of the jointly valid pixels agree within 1e-3."""
    va, vb = np.isfinite(ours), np.isfinite(ref)
    assert (va == vb).mean() >= 0.99
    both = va & vb
    assert (np.abs(ours[both] - ref[both]) <= 1e-3).mean() >= 0.99


def jax_match_sharded(name: str, n_tile: int) -> np.ndarray:
    """JAX's match_sharded of the case's first pair on a (1, n_tile) mesh
    of the conftest's virtual devices, on its exact jnp mirrors."""
    if len(jax.devices()) < n_tile:
        pytest.skip(f"needs {n_tile} virtual devices")
    size, opts, axis, backend, _, _ = cases.CASES[name]
    assert backend == "roll"
    lefts, rights, gls, grs = cases.pairs(name)
    return np.asarray(jax_sharded.match_sharded(
        jnp.asarray(lefts[0]), jnp.asarray(rights[0]), jnp.asarray(gls[0]),
        jnp.asarray(grs[0]), JaxOptions(**opts),
        jax_mesh.make_mesh(n_data=1, n_tile=n_tile), use_pallas=False,
        volume_axis=axis,
    ))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ROWS)
def test_rows_bitwise_match_core_on_every_rank(ranks, world, name):
    """Odd shapes take the padded path; rows_multi_hop at 4 ranks has 8
    rows a rank and a 12-row halo; rows_negative_min reads columns
    beyond the image at the right edge; rows_flags has the LR check off
    and both refinement flags on (kernels M1 and M2's wrappers)."""
    outs = [r[name] for r in ranks[world]]
    assert_ranks_bitwise(outs, core(name)[0])


@pytest.mark.parametrize("world", WORLDS)
def test_rows_against_jax_match_sharded(ranks, world):
    ours = ranks[world][0]["rows"].numpy()
    assert_close_to_jax(ours, jax_match_sharded("rows", world))


@pytest.mark.parametrize("world", WORLDS)
def test_meshes_over_the_world(ranks, world):
    """pod_mesh covers every rank (one host: all of them tile); a mesh
    that does not cover the world raises ValueError."""
    assert ranks[world][0]["pod_mesh"] == (1, world)
    for r in ranks[world]:
        assert "does not match the world" in r["make_mesh_error"]


def test_initialize_fails_fast():
    """initialize checks its arguments before touching torch.distributed
    (a bad configuration must raise, not hang), in JAX's order."""
    assert not dist.is_initialized()
    for kwargs, words in (
        (dict(world_size=2), "together"),
        (dict(world_size=2, rank=2), "out of range"),
        (dict(world_size=0, rank=0), "must be > 0"),
        (dict(world_size=2, rank=0), "coordinator"),
    ):
        with pytest.raises(ValueError, match=words):
            distributed.initialize(**kwargs)
        assert not dist.is_initialized()


def test_world_of_one_in_process():
    """One process, no init_method: an in-memory rendezvous on gloo and a
    (1, 1) mesh. Both layouts, with no halo exchange, are bitwise
    match_core, and the process group is torn down after."""
    distributed.initialize()
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = make_mesh(1, 1, "cpu")
        stacks = [torch.as_tensor(a[0]) for a in cases.pairs("rows_odd")]
        ref = core("rows_odd")[0]
        for axis in sharded.VOLUME_AXES:
            out = sharded.match_sharded(*stacks, cases.options("rows_odd"),
                                        mesh, volume_axis=axis)
            assert_ranks_bitwise([out], ref)
        with pytest.raises(ValueError, match="volume_axis"):
            sharded.match_sharded(*stacks, cases.options("rows_odd"), mesh,
                                  volume_axis="cols")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
