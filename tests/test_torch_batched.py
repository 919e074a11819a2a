"""The port's multi-pair pipelines (adcensus_torch/stages/pipeline.py:
match_batched_device, match_hetero_device, match_batched and the group
rule) on the CPU: bitwise equal to the port's own per-pair
match_device, close to the JAX package's eager batched and mixed-shape
programs, and their input checks; and the graph cache's bookkeeping
(adcensus_torch/utils/graphs.py), which needs no card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.stages import cost as torch_cost
from adcensus_torch.stages import pipeline as torch_pipeline
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.synthetic import two_layer_pair
from adcensus_torch.utils import graphs
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import pipeline as jax_pipeline

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)
SMALL_OPTS = dict(max_disparity=8, cross_L1=8, cross_L2=4)


def _assert_bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_mostly_equal(ours, ref):
    """>= 99 % of pixels equal, validity included: equal values, or
    invalid (+inf) in both. torch's and XLA's float32 exp differ by one
    ulp on some inputs, which can move a few winners."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    same = (ours == ref) | (np.isinf(ours) & np.isinf(ref))
    assert same.mean() >= 0.99, same.mean()


@pytest.fixture(scope="module")
def batch():
    """Three distinct 32x48 pairs as (3, 32, 48, 3) stacks (the third is
    the first mirrored, left and right swapped: a stereo pair with the
    same disparities), and each pair's match_device."""
    pairs = [two_layer_pair(32, 48, 4, 9, seed=s)[:2] for s in (1, 2)]
    left, right = pairs[0]
    pairs.append((np.ascontiguousarray(right[:, ::-1]),
                  np.ascontiguousarray(left[:, ::-1])))
    lefts, rights = (np.stack(side) for side in zip(*pairs))
    opts = ADCensusOptions(**OPTS)
    singles = [torch_pipeline.match_device(lefts[i], rights[i], opts,
                                           device="cpu") for i in range(3)]
    return lefts, rights, singles


@pytest.fixture(scope="module")
def hetero(batch):
    """A 32x48 pair at D = 16 and a 28x44 pair at D = 8, with options."""
    lefts, rights, _ = batch
    pairs = ((lefts[0], rights[0]), two_layer_pair(28, 44, 2, 5, seed=4)[:2])
    return pairs, (OPTS, SMALL_OPTS)


@pytest.fixture(scope="module")
def jax_results(batch, hetero):
    """JAX's eager batched program (group 3) on the batch and its
    mixed-shape program on the two pairs, as numpy arrays."""
    lefts, rights, _ = batch
    pairs, opts_seq = hetero
    with jax.disable_jit():
        batched = jax_pipeline.match_batched_device(
            jnp.asarray(lefts), jnp.asarray(rights), JaxOptions(**OPTS),
            use_pallas=False, group=3,
        )
        mixed = jax_pipeline.match_hetero_device(
            tuple((jnp.asarray(l), jnp.asarray(r)) for l, r in pairs),
            tuple(JaxOptions(**o) for o in opts_seq), use_pallas=False,
        )
    return np.asarray(batched), [np.asarray(m) for m in mixed]


@pytest.mark.parametrize("group", [1, 3, None])
def test_batched_equals_match_device(batch, group):
    lefts, rights, singles = batch
    out = torch_pipeline.match_batched_device(
        lefts, rights, ADCensusOptions(**OPTS), device="cpu", group=group)
    assert out.shape == (3, 32, 48)
    for i in range(3):
        _assert_bitwise(out[i], singles[i])


def test_batched_with_flags_equals_match_device(batch):
    """With the in-place median and discontinuity adjustment on, each
    output equals that pair's match_device bit for bit."""
    lefts, rights, singles = batch
    opts = ADCensusOptions(**OPTS, exact_median=True,
                           do_discontinuity_adjustment=True)
    out = torch_pipeline.match_batched_device(lefts, rights, opts,
                                              device="cpu")
    for i in range(3):
        _assert_bitwise(out[i], torch_pipeline.match_device(
            lefts[i], rights[i], opts, device="cpu"))
    assert not torch.equal(out[0], singles[0])


def test_batched_takes_tensors(batch):
    lefts, rights, singles = batch
    out = torch_pipeline.match_batched_device(
        torch.as_tensor(lefts), torch.as_tensor(rights),
        ADCensusOptions(**OPTS), device="cpu")
    for i in range(3):
        _assert_bitwise(out[i], singles[i])


def test_batched_close_to_jax(batch, jax_results):
    lefts, rights, _ = batch
    out = torch_pipeline.match_batched_device(
        lefts, rights, ADCensusOptions(**OPTS), device="cpu", group=3)
    _assert_mostly_equal(out.numpy(), jax_results[0])


@pytest.mark.parametrize("group", [0, 2, 4, -1])
def test_group_that_does_not_divide_raises_first(batch, group,
                                                 monkeypatch):
    """Before any match runs."""
    lefts, rights, _ = batch

    def no_match(*args, **kwargs):
        raise AssertionError("a match ran")

    monkeypatch.setattr(torch_pipeline, "match_core", no_match)
    with pytest.raises(ValueError, match="must divide"):
        torch_pipeline.match_batched_device(
            lefts, rights, ADCensusOptions(**OPTS), device="cpu",
            group=group)


def test_hetero_equals_match_device(hetero):
    pairs, opts_seq = hetero
    outs = torch_pipeline.match_hetero_device(
        pairs, tuple(ADCensusOptions(**o) for o in opts_seq), device="cpu")
    assert [tuple(o.shape) for o in outs] == [(32, 48), (28, 44)]
    for (left, right), o, out in zip(pairs, opts_seq, outs):
        _assert_bitwise(out, torch_pipeline.match_device(
            left, right, ADCensusOptions(**o), device="cpu"))


def test_hetero_close_to_jax(hetero, jax_results):
    pairs, opts_seq = hetero
    outs = torch_pipeline.match_hetero_device(
        pairs, tuple(ADCensusOptions(**o) for o in opts_seq), device="cpu")
    for out, ref in zip(outs, jax_results[1]):
        _assert_mostly_equal(out.numpy(), ref)


def test_match_batched_with_grays_equals_device_gray(batch):
    """Grays computed as the device path computes them give the same
    disparities; host64 grays give a map of the same shape."""
    lefts, rights, singles = batch
    opts = ADCensusOptions(**OPTS)
    grays = [torch_cost.compute_gray(torch.as_tensor(s)) for s in
             (lefts, rights)]
    out = torch_pipeline.match_batched(lefts, rights, *grays, opts,
                                       device="cpu")
    for i in range(3):
        _assert_bitwise(out[i], singles[i])
    host64 = [torch_cost.compute_gray_host64(s) for s in (lefts, rights)]
    out64 = torch_pipeline.match_batched(lefts, rights, *host64, opts,
                                         device="cpu")
    assert out64.shape == (3, 32, 48)


def _bad_stacks(lefts, rights):
    gray = np.zeros(lefts.shape[:3], np.uint8)
    return {
        "one_pair": ((lefts[0], rights[0]), ValueError),
        "shapes_differ": ((lefts, rights[:, :, :40]), ValueError),
        "batches_differ": ((lefts, rights[:2]), ValueError),
        "empty": ((lefts[:0], rights[:0]), ValueError),
        "float": ((lefts.astype(np.float32), rights), TypeError),
        "gray_shape": ((lefts, rights, gray[:, :, :40], gray), ValueError),
        "gray_dtype": ((lefts, rights, gray, gray.astype(np.int32)),
                       TypeError),
    }


@pytest.mark.parametrize("case", ["one_pair", "shapes_differ",
                                  "batches_differ", "empty", "float",
                                  "gray_shape", "gray_dtype"])
def test_batched_rejects_bad_stacks(batch, case):
    lefts, rights, _ = batch
    stacks, error = _bad_stacks(lefts, rights)[case]
    opts = ADCensusOptions(**OPTS)
    with pytest.raises(error):
        if len(stacks) == 4:
            torch_pipeline.match_batched(*stacks, opts, device="cpu")
        else:
            torch_pipeline.match_batched_device(*stacks, opts, device="cpu")


def test_hetero_rejects_bad_input(hetero):
    pairs, opts_seq = hetero
    opts = tuple(ADCensusOptions(**o) for o in opts_seq)
    with pytest.raises(ValueError):
        torch_pipeline.match_hetero_device(pairs, opts[:1], device="cpu")
    with pytest.raises(ValueError):
        torch_pipeline.match_hetero_device((), (), device="cpu")
    (left, right), small = pairs
    with pytest.raises(ValueError):
        torch_pipeline.match_hetero_device(((left, right[:, :40]), small),
                                           opts, device="cpu")
    with pytest.raises(ValueError):
        torch_pipeline.match_hetero_device(pairs, opts, device="cpu",
                                           cross_backend="pallas")


def test_multi_pair_entry_points_need_cuda_by_default(batch, hetero,
                                                      monkeypatch):
    lefts, rights, _ = batch
    pairs, opts_seq = hetero
    opts = ADCensusOptions(**OPTS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_pipeline.match_batched_device(lefts, rights, opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_pipeline.match_batched(lefts, rights, lefts[..., 0],
                                     rights[..., 0], opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_pipeline.match_hetero_device(
            pairs, tuple(ADCensusOptions(**o) for o in opts_seq))


# (B, H, W, D): tiny, the test batch, Cone, JAX's own 481x707 D=256
# case, Wood2, and sizes whose groups fall between 1 and B
GROUP_CASES = [(1, 8, 8, 16), (3, 32, 48, 16), (8, 375, 450, 64),
               (8, 481, 707, 256), (6, 555, 653, 128), (12, 1080, 1920, 256),
               (7, 1000, 1500, 256), (9, 720, 1280, 192)]


@pytest.mark.parametrize("b,h,w,d", GROUP_CASES)
def test_group_size_equals_jax_off_the_card(b, h, w, d):
    ours = torch_pipeline._batch_group_size(
        b, h, w, ADCensusOptions(max_disparity=d), device="cpu")
    assert ours == jax_pipeline._batch_group_size(
        b, h, w, JaxOptions(max_disparity=d))
    if (b, h, w, d) == (1, 8, 8, 16):
        assert ours == 1
    if (b, h, w, d) == (8, 481, 707, 256):
        assert ours == 4


def test_group_size_on_the_card_uses_its_budget_and_backend():
    """No card needed: the rule only reads the device's type, and the
    budget is given."""
    opts = ADCensusOptions(max_disparity=64)
    roll = torch_pipeline.pair_bytes(375, 450, opts, "cuda")
    matmul = torch_pipeline.pair_bytes(375, 450, opts, "cuda", "matmul")
    assert roll > torch_pipeline.pair_bytes(375, 450, opts, "cpu")
    assert matmul == roll + 375 * 450 * (375 + 450) * 4
    size = torch_pipeline._batch_group_size
    assert size(8, 375, 450, opts, "cuda", budget=3 * roll) == 2
    assert size(8, 375, 450, opts, "cuda", budget=8 * roll) == 8
    assert size(8, 375, 450, opts, "cuda", budget=8 * roll,
                cross_backend="matmul") == 4
    assert torch_pipeline.group_budget("cpu") == 10 * 1024**3


def test_graph_cache_is_a_small_lru(monkeypatch):
    """The cache's bookkeeping, with the capture stubbed out: a hit
    captures nothing and moves its key to the end, a miss past
    CACHE_SIZE drops the least recently used graph, and clear() drops
    all."""
    made = []

    def fake_capture(device, make_buffers, run_branch, n, warm_up):
        made.append(n)
        return graphs.GroupGraph(None, *make_buffers(), {})

    monkeypatch.setattr(graphs, "_capture", fake_capture)
    graphs.clear()
    dev = torch.device("cuda", 0)
    start = graphs.captures

    def get(key):
        return graphs.captured(key, dev, lambda: ((key,), ()), None, 1, (0,))

    first = get("a")
    assert get("a") is first and len(made) == 1
    for key in "bcd":
        get(key)
    assert get("a") is first  # "a" is now the most recent
    get("e")  # drops "b"
    assert len(graphs.cached()) == graphs.CACHE_SIZE
    assert [e.inputs[0] for e in graphs.cached()] == ["c", "d", "a", "e"]
    assert graphs.captures - start == len(made) == 5
    graphs.clear()
    assert graphs.cached() == ()


def test_failed_capture_names_the_innermost_stage():
    """_stage_of reads the error's traceback, or that of the error it
    arose from, for the innermost frame of adcensus_torch/stages."""
    try:
        torch_refine.median_filter_3x3(None)
    except AttributeError as err:
        assert graphs._stage_of(err) == " in stage refine.median_filter_3x3"
        try:
            raise RuntimeError("capture invalidated")
        except RuntimeError as later:
            assert graphs._stage_of(later) == \
                " in stage refine.median_filter_3x3"
    assert graphs._stage_of(RuntimeError("no traceback")) == ""
