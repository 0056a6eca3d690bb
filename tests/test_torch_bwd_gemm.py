"""The backward's GEMM, mask and reduction around their kernels
(``ops/news_encoder.py``): the plain versions ``bwd_gemm_reference`` and
``emb_mask_reference``, which the wgmma GEMM and the mask kernel are held
against on the card, against float64 products of the same rounded inputs
and the Philox stream-0 mask; the slice planner ``gemm_splits`` /
``slice_rows`` and the reduction's chunk plan ``reduce_plan``, which fix
every gradient's summation order by the shapes alone; fp32's slice rule
``gemm_splits_fp32`` (the 3xTF32 kernel's) and its products' plain 3xTF32
versions against float64."""
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.ops import news_encoder as port
from ebnerd_tpu_torch.ops import philox

torch.set_num_threads(1)

SEED, KEEP = (0x5EED << 32) | 0x1234ABCD, 0.8
SMS = 132
# the NRMS step's weight-gradient products: (M, N, rows) -- news dWqkv and dW
# (22,370 valid articles x title 30), user dWqkv and dW (16,384 x history 20)
STEP_WGRAD = [(1024, 1280, 671_100), (400, 208, 671_100), (400, 1280, 327_680),
              (400, 208, 327_680)]
RAGGED_WGRAD = [(400, 208, 4_099), (72, 40, 67), (8, 8, 1), (1024, 1280, 4_096 * 3 + 1),
                (400, 208, 0)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)


def _f64(t):
    return t.to(torch.float64).numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("r_all,rows,m,n", [(130, 67, 72, 40), (300, 300, 400, 208),
                                            (97, 1, 16, 8)])
def test_weight_gradient_reference_matches_float64(masked, r_all, rows, m, n):
    """sum over rows [0, rows) of round(a * mask)^T b: rows past ``rows``
    add nothing, the mask is Philox stream 0 of (row, column), a * mask is
    rounded to bf16 before the product."""
    rng = np.random.default_rng(r_all + m)
    a, b = _bf16(rng, r_all, m), _bf16(rng, r_all, n)
    a[rows:] = 1e4  # must not reach the sum
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED) if masked else port.Dropout()
    out = port.bwd_gemm_reference(a, b, dx=False, rows=rows, drop=drop, seed=SEED, emb_keep=KEEP)
    am = _f64(a)[:rows]
    if masked:
        mask = _f64(philox.mask(SEED, philox.STREAM_EMB, rows, m, KEEP))
        am = _f64(torch.from_numpy(am * mask).to(torch.bfloat16))
    want = am.T @ _f64(b)[:rows]
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(_f64(out), want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m_all,rows,n,k", [(130, 67, 72, 48), (64, 64, 400, 1280), (9, 0, 8, 16)])
def test_dx_reference_matches_float64(masked, m_all, rows, n, k):
    """(a b^T) * mask in bf16, the mask Philox stream 0 of (row, column);
    rows at or past ``rows`` exactly 0."""
    rng = np.random.default_rng(m_all + n)
    a, b = _bf16(rng, m_all, k), _bf16(rng, n, k)
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED) if masked else port.Dropout()
    out = port.bwd_gemm_reference(a, b, dx=True, rows=rows, drop=drop, seed=SEED, emb_keep=KEEP)
    want = _f64(a) @ _f64(b).T
    if masked:
        want = want * _f64(philox.mask(SEED, philox.STREAM_EMB, m_all, n, KEEP))
    want[rows:] = 0.0
    assert out.dtype == torch.bfloat16 and out.shape == (m_all, n)
    assert (out[rows:] == 0).all()
    # one bf16 rounding of the fp32 result: within 2**-8 relative
    np.testing.assert_allclose(_f64(out), want, rtol=2.0 ** -8, atol=1e-3)


@pytest.mark.parametrize("rows,width", [(67, 400), (5, 1024), (3, 40), (0, 8)])
def test_emb_mask_reference_is_the_stream0_mask(rows, width):
    """The mask kernel's plain version: round(x * mask) in bf16 over rows
    [0, rows), and the keep bits packed 32 columns to an int32 word (bit j
    of word q is column 32 q + j; zeros past the width)."""
    rng = np.random.default_rng(rows + width)
    x = _bf16(rng, rows + 2, width)
    xm, keep = port.emb_mask_reference(rows, width, SEED, KEEP, x=x)
    mask = philox.mask(SEED, philox.STREAM_EMB, rows, width, KEEP)
    assert xm.dtype == torch.bfloat16 and torch.equal(xm, (x[:rows].float() * mask).to(torch.bfloat16))
    assert keep.dtype == torch.int32 and keep.shape == (rows, -(-width // 32))
    words = keep.numpy().astype(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(rows, keep.shape[1] * 32)
    assert (bits[:, :width] == (mask.numpy() > 0)).all() and not bits[:, width:].any()
    assert port.emb_mask_reference(rows, width, SEED, KEEP)[0] is None


def test_pack_bits_sets_the_sign_bit_for_column_31():
    kept = torch.zeros(2, 33, dtype=torch.bool)
    kept[0, 31] = kept[1, 0] = kept[1, 32] = True
    assert port.pack_bits(kept).tolist() == [[-(1 << 31), 0], [1, 1]]


def _slices(rows, splits):
    kps = port.slice_rows(rows, splits)
    return kps, [(z * kps, min(rows, (z + 1) * kps)) for z in range(splits)]


@pytest.mark.parametrize("m,n,rows", STEP_WGRAD + RAGGED_WGRAD)
def test_slices_cover_each_row_once_in_whole_k_tiles(m, n, rows):
    splits = port.gemm_splits(m, n, rows)
    kps, slices = _slices(rows, splits)
    assert 1 <= splits <= 64 and kps % 64 == 0
    covered = np.zeros(rows, np.int64)
    for lo, hi in slices:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert all(lo < hi for lo, hi in slices) or rows == 0  # no slice is left empty


@pytest.mark.parametrize("m,n,rows", STEP_WGRAD)
def test_step_shapes_fill_a_wave_of_ctas(m, n, rows):
    splits = port.gemm_splits(m, n, rows)
    tiles = -(-m // 128) * -(-n // 256)
    assert tiles * splits >= SMS
    assert port.slice_rows(rows, splits) >= 4096


def test_plans_depend_on_the_shapes_alone():
    """The same shapes give the same plan whatever was planned before (no
    state, no device query): the summation order, and so the bits, of every
    gradient are fixed by the shapes."""
    shapes = STEP_WGRAD + RAGGED_WGRAD
    first = [(port.gemm_splits(*s), port.reduce_plan(s[2], s[0] * s[1])) for s in shapes]
    again = [(port.gemm_splits(*s), port.reduce_plan(s[2], s[0] * s[1])) for s in shapes[::-1]]
    assert first == again[::-1]
    assert [port.gemm_splits(*s) for s in STEP_WGRAD] == [13, 33, 13, 33]


@pytest.mark.parametrize("nrows,ncols", [(13, 1_310_720), (33, 83_200), (11_185, 208),
                                         (13, 512_000), (5_462, 208), (3, 7), (65, 5), (0, 4)])
def test_reduce_plan_chunks(nrows, ncols):
    """One pass when the columns give 2 blocks per SM or the rows are few;
    else chunks of at least 64 rows that cover the rows once, enough for
    that many blocks where the rows allow."""
    per = port.reduce_plan(nrows, ncols)
    chunks = -(-nrows // per)
    assert per >= 1 and (chunks - 1) * per < max(nrows, 1)
    vec = 4 if ncols % 4 == 0 else 1
    blocks = -(-(ncols // vec) // (32 * (1 if nrows > 32 else 8)))
    if chunks > 1:
        assert per >= 64 and (blocks * chunks >= 2 * SMS or chunks == nrows // 64)
    else:
        assert blocks >= 2 * SMS or nrows < 128


def test_wrappers_take_no_cpu_tensors():
    """On the CPU the GEMM and the reduction have only their plain
    versions; the kernels' wrappers raise rather than fall back."""
    a = torch.zeros(8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        port.bwd_gemm(a, a, dx=False, rows=8)
    with pytest.raises(ValueError, match="no kernel"):
        port.reduce_rows(torch.zeros(4, 4))
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED)
    with pytest.raises(ValueError, match="no kernel"):
        port.emb_mask(4, 8, drop, device="cpu", x=a)


@pytest.mark.parametrize("dx", [True, False])
def test_bf16_gemm_takes_the_mask_as_emb_mask_draws_it(dx):
    """In bf16 the GEMM does not draw the stream-0 mask: dx needs the keep
    bits and the weight gradient an operand already masked (with
    ``Dropout()``), as the backward passes them; a Philox config alone is
    refused rather than silently left unmasked."""
    a = torch.zeros(8, 8, dtype=torch.bfloat16)
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED)
    with pytest.raises(ValueError, match="emb_mask"):
        port.bwd_gemm(a, a, dx=dx, rows=8, drop=drop)


# fp32's GEMM on the tensor cores (3xTF32, ``gemm_splits_fp32``): its 128 x 256 tiles, slices
# of whole 32-row k-tiles. The CLI's news tower (train_newsrec.py: 461 valid articles of 30
# tokens, Din 300): dWqkv [300, 1,280] and dW [400, 208]; then the fp32 step's four at full width
CLI_WGRAD = [(300, 1280, 13_830), (400, 208, 13_830)]


def _fp32_slices(rows, splits):
    kps = port.slice_rows(rows, splits, 32)
    return kps, [(z * kps, min(rows, (z + 1) * kps)) for z in range(splits)]


@pytest.mark.parametrize("m,n,rows", CLI_WGRAD + STEP_WGRAD + RAGGED_WGRAD)
def test_fp32_slices_cover_each_row_once_in_whole_k_tiles(m, n, rows):
    """Every row in exactly one slice, each slice whole 32-row k-tiles (the
    kernel refuses any other), at least 256 rows where the rows allow and at
    most 4,096 (the tensor cores' fp32 accumulation loses accuracy with a
    slice's rows)."""
    splits = port.gemm_splits_fp32(m, n, rows)
    kps, slices = _fp32_slices(rows, splits)
    assert 1 <= splits <= 256 and kps % 32 == 0 and kps <= 4096
    assert kps >= min(256, max(rows, 1)) or splits == 1
    covered = np.zeros(rows, np.int64)
    for lo, hi in slices:
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,n,rows", CLI_WGRAD + STEP_WGRAD)
def test_fp32_slices_fill_a_wave_of_ctas(m, n, rows):
    """At the CLI's news tower and the fp32 step's towers the grid has at
    least one CTA for each of the card's 132 SMs (the bf16 rule's 4,096-row
    slices gave the CLI's dW 4 x 3 = 12 tiles of the 3xTF32 kernel)."""
    splits = port.gemm_splits_fp32(m, n, rows)
    tiles = -(-m // 128) * -(-n // 256)
    assert tiles * splits >= SMS
    assert tiles * port.gemm_splits(m, n, rows) < SMS or rows > 100_000


def test_fp32_plan_depends_on_the_shapes_alone():
    shapes = CLI_WGRAD + STEP_WGRAD + RAGGED_WGRAD
    first = [port.gemm_splits_fp32(*s) for s in shapes]
    again = [port.gemm_splits_fp32(*s) for s in shapes[::-1]]
    assert first == again[::-1]
    assert [port.gemm_splits_fp32(*s) for s in CLI_WGRAD + STEP_WGRAD] == [26, 33, 164, 164, 85,
                                                                          98]


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "tf32x3")])
def test_gemm_variant_by_dtype(dtype, want):
    assert port.gemm_variant(dtype) == want


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("r_all,rows,m,n", [(4_200, 4_163, 300, 136), (900, 777, 72, 40),
                                            (64, 1, 16, 8)])
def test_fp32_weight_gradient_in_3xtf32_matches_float64(masked, r_all, rows, m, n):
    """The 3xTF32 kernel's plain version of a weight gradient: each slice
    of ``gemm_splits_fp32`` a 3xTF32 product, the slices summed in order
    (``reduce_rows``' order for up to 32 partials), within 2e-6 of a
    float64 product's scale; rows past ``rows`` add nothing."""
    rng = np.random.default_rng(r_all + m + masked)
    a, b = _f32(rng, r_all, m), _f32(rng, r_all, n, scale=1e-2)
    a[rows:] = 1e4
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED) if masked else port.Dropout()
    splits = port.gemm_splits_fp32(m, n, rows)
    out = port.bwd_gemm_reference(a, b, dx=False, rows=rows, drop=drop, seed=SEED, emb_keep=KEEP,
                                  tf32_passes=3, splits=splits)
    am = _f64(a)[:rows]
    if masked:
        am = am * _f64(philox.mask(SEED, philox.STREAM_EMB, rows, m, KEEP))
    want = am.T @ _f64(b)[:rows]
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert np.abs(_f64(out) - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m_all,rows,n,k", [(300, 277, 300, 1280), (130, 67, 72, 48)])
def test_fp32_dx_in_3xtf32_matches_float64(masked, m_all, rows, n, k):
    """dx's plain 3xTF32 version: (dqkv Wqkv^T) * mask within 2e-6 of a
    float64 product's scale, rows at or past ``rows`` exactly 0."""
    rng = np.random.default_rng(m_all + n + masked)
    a, b = _f32(rng, m_all, k, scale=1e-2), _f32(rng, n, k, scale=0.05)
    drop = port.dropout_config(1, 1, 4, KEEP, KEEP, SEED) if masked else port.Dropout()
    out = port.bwd_gemm_reference(a, b, dx=True, rows=rows, drop=drop, seed=SEED, emb_keep=KEEP,
                                  tf32_passes=3)
    want = _f64(a) @ _f64(b).T
    if masked:
        want = want * _f64(philox.mask(SEED, philox.STREAM_EMB, m_all, n, KEEP))
    want[rows:] = 0.0
    assert (out[rows:] == 0).all()
    assert np.abs(_f64(out) - want).max() <= 2e-6 * np.abs(want).max()


def test_tf32_passes_are_checked():
    a = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="tf32_passes"):
        port.bwd_gemm_reference(a, a, dx=True, rows=8, tf32_passes=1)
    with pytest.raises(ValueError, match="tf32_passes"):
        port.bwd_gemm_reference(a.to(torch.bfloat16), a.to(torch.bfloat16), dx=False, rows=8,
                                tf32_passes=3)
