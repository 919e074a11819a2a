"""The port's sharded layer (adcensus_torch/parallel/), disp layout and
the batched call over the data dim, on the CPU: ranks spawned over gloo
at 2 and 4 (tests/_sharded_cases.py). Every case is bitwise the port's
own match_core and the same on every rank; the layout meets
test_torch_pipeline.py's tolerance against JAX's match_sharded on a mesh
of the same tile count; a disparity range the tiles do not divide
raises ValueError. The rows layout is tests/test_torch_sharded.py."""
import pytest

import _sharded_cases as cases
from test_torch_sharded import (
    assert_close_to_jax,
    assert_ranks_bitwise,
    core,
    jax_match_sharded,
)

DISP = ["disp", "disp_odd", "disp_flags", "disp_matmul"]
BATCHED = ["batched_rows", "batched_disp"]  # on a (data 2, tile 2) mesh
INDIVISIBLE = "disp_indivisible"
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's results: the DISP cases at 2 and 4 ranks, the
    BATCHED cases at 4."""
    return {world: cases.run(world, DISP + (BATCHED if world == 4 else [])
                             + [INDIVISIBLE],
                             tmp_path_factory.mktemp("store"))
            for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", DISP)
def test_disp_bitwise_match_core_on_every_rank(ranks, world, name):
    """D = 8 in blocks of 4 or 2 planes; disp_matmul aggregates the
    plane blocks by band matrices."""
    assert_ranks_bitwise([r[name] for r in ranks[world]], core(name)[0])


@pytest.mark.parametrize("name", BATCHED)
def test_batched_bitwise_match_core_on_every_rank(ranks, name):
    """match_sharded_batched of 2 pairs on a (data 2, tile 2) mesh: each
    data coordinate matches one pair, and every rank returns both."""
    assert_ranks_bitwise([r[name] for r in ranks[4]], core(name))


@pytest.mark.parametrize("world", WORLDS)
def test_disp_against_jax_match_sharded(ranks, world):
    ours = ranks[world][0]["disp"].numpy()
    assert_close_to_jax(ours, jax_match_sharded("disp", world))


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_disp_range_raises(ranks, world):
    """D = 7 over 2 or 4 tiles (JAX's
    test_disp_sharded_rejects_indivisible), raise before any collective
    on every rank."""
    for r in ranks[world]:
        assert "multiple of the mesh" in r[INDIVISIBLE]
