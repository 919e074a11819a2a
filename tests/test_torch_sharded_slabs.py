"""The slab modes that the port's sharded layer (adcensus_torch/parallel/)
calls in the stages, against the JAX package's on the CPU, bitwise but for
the cost planes: census and arms of a row slab judged in the image's
coordinates, cost planes from a disparity offset, the masked out-of-place
median, the LR check of a padded map, the penalty codes of a column
slab, and the in-place median of a gathered map cropped to the image."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.stages import arms as torch_arms
from adcensus_torch.stages import cost as torch_cost
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.stages import scanline as torch_scan
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.parallel import sharded as jax_sharded
from adcensus_tpu.stages import arms as jax_arms
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import refine as jax_refine

H, W = 26, 36
OPTS = dict(max_disparity=12, cross_L1=8, cross_L2=4)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def pair():
    left, right, _ = two_layer_pair(H, W, 3, 7, seed=2)
    return left, right


# (first row, rows, full_h, full_w): slabs at the top, in the middle and
# at the bottom of the image, a slab reaching into padding rows, columns
# of padding (full_w < W), and an image too small for any census
SLABS = [(0, 12, H, W), (7, 10, H, W), (14, 12, H, W), (18, 8, 22, 30),
         (0, 9, 7, W)]


@pytest.mark.parametrize("r0,rows,full_h,full_w", SLABS)
def test_census_slab_bitwise(pair, r0, rows, full_h, full_w):
    """census_transform_9x7 with row_offset/full_h/full_w gives JAX's
    packed signatures, unpacked, bit for bit."""
    gray = torch_cost.compute_gray_host64(pair[0])
    slab = np.ascontiguousarray(gray[r0 : r0 + rows])
    ref = jax_cost.census_packed_to_u64(np.asarray(
        jax_cost.census_transform_9x7(jnp.asarray(slab), row_offset=r0,
                                      full_h=full_h, full_w=full_w)))
    ours = torch_cost.census_transform_9x7(
        torch.as_tensor(slab), row_offset=r0, full_h=full_h, full_w=full_w)
    np.testing.assert_array_equal(torch_cost.census_to_u64(ours), ref)


def test_census_slab_rows_equal_full_image(pair):
    """A slab with 4 rows of context gives the full image's signatures on
    the rows it keeps."""
    gray = torch.as_tensor(torch_cost.compute_gray_host64(pair[0]))
    full = torch_cost.census_transform_9x7(gray)
    slab = torch_cost.census_transform_9x7(gray[6:20], row_offset=6,
                                           full_h=H, full_w=W)
    assert torch.equal(slab[4:10], full[10:16])


@pytest.mark.parametrize("r0,rows,full_h,full_w", SLABS[:4])
def test_build_arms_slab_bitwise(pair, r0, rows, full_h, full_w):
    """build_arms in slab mode gives JAX's arms bit for bit."""
    slab = np.ascontiguousarray(pair[0][r0 : r0 + rows])
    ref = np.asarray(jax_arms.build_arms(
        jnp.asarray(slab), JaxOptions(**OPTS), row_offset=r0, full_h=full_h,
        full_w=full_w))
    ours = torch_arms.build_arms(torch.as_tensor(slab),
                                 ADCensusOptions(**OPTS), row_offset=r0,
                                 full_h=full_h, full_w=full_w)
    np.testing.assert_array_equal(ours.numpy(), ref)


def _census_pair(left, right):
    gl = torch_cost.compute_gray_host64(left)
    gr = torch_cost.compute_gray_host64(right)
    return (torch_cost.census_transform_9x7(torch.as_tensor(gl)),
            torch_cost.census_transform_9x7(torch.as_tensor(gr)),
            jax_cost.census_transform_9x7(jnp.asarray(gl)),
            jax_cost.census_transform_9x7(jnp.asarray(gr)))


@pytest.mark.parametrize("d_min,d0,d_count", [(0, 0, 12), (0, 4, 4),
                                               (0, 9, 3), (-4, 2, 5)])
def test_cost_planes(pair, d_min, d0, d_count):
    """compute_cost_planes holds JAX's planes to atol 1e-6 (torch's and
    XLA's float32 exp differ by an ulp) and gives the port's own
    compute_cost_volume planes bit for bit."""
    left, right = pair
    kw = dict(OPTS, min_disparity=d_min, max_disparity=d_min + 12)
    cl, cr, jcl, jcr = _census_pair(left, right)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    ours = torch_cost.compute_cost_planes(lt, rt, cl, cr,
                                          ADCensusOptions(**kw), d0, d_count)
    ref = np.asarray(jax_cost.compute_cost_planes(
        jnp.asarray(left), jnp.asarray(right), jcl, jcr, JaxOptions(**kw),
        d0, d_count))
    assert ours.shape == (d_count, H, W) and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    whole = torch_cost.compute_cost_volume(lt, rt, cl, cr,
                                           ADCensusOptions(**kw))
    np.testing.assert_array_equal(_bits(ours), _bits(whole[d0 : d0 + d_count]))


def test_cost_planes_real_width_of_padded_images(pair):
    """With real_w, the planes of images padded on the right give the
    unpadded volume on the real columns bit for bit, negative disparities
    included (columns x - d at or beyond real_w are out of the image, as
    unpadded; without real_w they would read the padding)."""
    left, right = pair
    opts = ADCensusOptions(**dict(OPTS, min_disparity=-3, max_disparity=9))
    pad = ((0, 0), (0, 4), (0, 0))
    cl, cr, _, _ = _census_pair(left, right)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    whole = torch_cost.compute_cost_volume(lt, rt, cl, cr, opts)
    zeros = torch.zeros((H, 4), dtype=torch.int64)
    args = (torch.as_tensor(np.pad(left, pad)),
            torch.as_tensor(np.pad(right, pad)), torch.cat([cl, zeros], 1),
            torch.cat([cr, zeros], 1), opts, 0, opts.disp_range)
    padded = torch_cost.compute_cost_planes(*args, real_w=W)
    np.testing.assert_array_equal(_bits(padded[:, :, :W]), _bits(whole))
    # JAX's sharded layer costs these cells from the padding
    reads_padding = torch_cost.compute_cost_planes(*args)
    assert not torch.equal(reads_padding[:, :, :W], whole)


def _map_with_holes(h, w, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 16, (h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.2] = np.inf
    return d


def _in_image(h, w, rows, cols):
    m = np.zeros((h, w), bool)
    m[:rows, :cols] = True
    return m


@pytest.mark.parametrize("rows,cols", [(18, 24), (15, 24), (18, 21),
                                       (14, 19), (1, 24), (18, 1)])
def test_median_in_image_bitwise(rows, cols):
    """median_filter_3x3(disp, in_image) on maps with +inf gives JAX's,
    with masks whose bottom rows and right columns are False."""
    d = _map_with_holes(18, 24, seed=rows * 100 + cols)
    m = _in_image(18, 24, rows, cols)
    ref = jax_refine.median_filter_3x3(jnp.asarray(d), jnp.asarray(m))
    ours = torch_refine.median_filter_3x3(torch.as_tensor(d),
                                          torch.as_tensor(m))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_median_in_image_of_whole_map_is_unmasked():
    d = torch.as_tensor(_map_with_holes(18, 24, seed=5))
    full = torch.ones((18, 24), dtype=torch.bool)
    assert torch.equal(
        torch_refine.median_filter_3x3(d, full).view(torch.int32),
        torch_refine.median_filter_3x3(d).view(torch.int32))


@pytest.mark.parametrize("rows,cols", [(18, 24), (15, 21), (13, 24)])
def test_inplace_median_of_cropped_map(rows, cols):
    """The sharded layer runs kernel M1's wrapper on the gathered map
    cropped to the image; that is JAX's masked in-place median there."""
    d = _map_with_holes(18, 24, seed=rows + cols)
    m = _in_image(18, 24, rows, cols)
    ref = np.asarray(jax_refine.median_filter_3x3_inplace(
        jnp.asarray(d), jnp.asarray(m)))[:rows, :cols]
    ours = torch_refine.median_filter_3x3_inplace(
        torch.as_tensor(d)[:rows, :cols])
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("real_w", [None, 30, 33])
def test_outlier_detection_real_width(real_w):
    """outlier_detection with real_w (a map padded on the right) gives
    JAX's three outputs bit for bit."""
    rng = np.random.default_rng(7)
    dl = rng.integers(0, 12, (16, 36)).astype(np.float32) + 0.25
    dr = dl + rng.choice([0.0, 0.5, 3.0], (16, 36)).astype(np.float32)
    dl[rng.random((16, 36)) < 0.1] = np.inf
    jo, to = JaxOptions(**OPTS), ADCensusOptions(**OPTS)
    ref = jax_refine.outlier_detection(jnp.asarray(dl), jnp.asarray(dr), jo,
                                       real_w=real_w)
    ours = torch_refine.outlier_detection(torch.as_tensor(dl),
                                          torch.as_tensor(dr), to,
                                          real_w=real_w)
    np.testing.assert_array_equal(_bits(ours[0]), _bits(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("d_min,col0,out_w,real_w", [
    (0, 0, 36, 36), (0, 9, 9, 36), (0, 27, 9, 33), (-3, 18, 9, 34)])
def test_code_volume_column_slab(pair, d_min, col0, out_w, real_w):
    """code_volume on a column slab with the full-width right-image
    distances gives JAX's sharded _code_volume bit for bit."""
    left, right = pair
    kw = dict(OPTS, min_disparity=d_min, max_disparity=d_min + 12)
    rng = np.random.default_rng(col0)
    d1 = rng.integers(0, 30, (H, out_w)).astype(np.int32)
    rd = rng.integers(0, 30, (H, W)).astype(np.int32)
    ref = jax_sharded._code_volume(jnp.asarray(d1), jnp.asarray(rd),
                                   JaxOptions(**kw), real_w, col0, out_w)
    ours = torch_scan.code_volume(torch.as_tensor(d1), torch.as_tensor(rd),
                                  ADCensusOptions(**kw), real_w, col0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
