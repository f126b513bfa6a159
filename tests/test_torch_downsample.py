"""The port's downsample program (K6's plain twins) and pyramid-writer host
code against the JAX package, on the CPU.

Inputs are drawn from ``np.random.default_rng(seed)`` and go through the
JAX function (jitted on the CPU, as the JAX package's own tests run it) and
the port's wrapper on CPU tensors, which takes K6's plain twin.
Tolerances: for integer inputs and power-of-two factors every sum and
quotient is exact, so outputs must be bitwise equal; a factor of 3 divides
inexactly and XLA's order for sums of more than two operands is not
pinned, so float32 means are held to rtol 1e-6 and storage integers to
|delta| <= 1; float32 inputs are held to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.io.chunkstore import ChunkStore as JStore
from bigstitcher_spark_tpu.io.chunkstore import StorageFormat as JFormat
from bigstitcher_spark_tpu.models import downsample_driver as JD
from bigstitcher_spark_tpu.ops import downsample as JOps
from bigstitcher_spark_tpu.utils.grid import create_grid as jgrid
from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore, StorageFormat
from bigstitcher_spark_tpu_torch.io.container import MultiResolutionLevelInfo
from bigstitcher_spark_tpu_torch.models import downsample_driver as TD
from bigstitcher_spark_tpu_torch.ops import downsample as TOps
from bigstitcher_spark_tpu_torch.utils.grid import create_grid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU pool is far slower than one thread on small tensors here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FACTORS = [(2, 2, 2), (2, 2, 1), (4, 4, 4), (3, 1, 2)]
DTYPES = ["uint8", "uint16", "float32"]


def _data(rng, shape, dtype):
    if dtype == "float32":
        return rng.uniform(0, 4000, shape).astype(np.float32)
    hi = 256 if dtype == "uint8" else 65536
    return rng.integers(0, hi, shape).astype(dtype)


def _exact(dtype, factors):
    return dtype != "float32" and all(f & (f - 1) == 0 for f in factors)


@pytest.mark.parametrize("factors", FACTORS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_downsample_block_matches_jax(dtype, factors):
    rng = np.random.default_rng(31)
    x = _data(rng, (24, 20, 16), dtype)
    ref = np.asarray(JOps.downsample_block(x, factors))
    got = TOps.downsample_block(torch.from_numpy(x), factors).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if _exact(dtype, factors):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


LEVEL_CASES = [
    # (prev shape, factors, dims): an odd-extent crop, the thin-axis edge
    # pad of test_epilogue's thin case (a z window of 8 over 6 planes),
    # an anisotropic step, a factor of 3, and a 4x step
    ((25, 19, 11), (2, 2, 2), (12, 9, 5)),
    ((56, 32, 6), (2, 2, 8), (28, 16, 1)),
    ((23, 20, 9), (2, 2, 1), (11, 10, 9)),
    ((20, 17, 9), (3, 1, 2), (6, 17, 4)),
    ((33, 16, 12), (4, 4, 4), (8, 4, 3)),
]


@pytest.mark.parametrize("shape,factors,dims", LEVEL_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_downsample_level_matches_jax(dtype, shape, factors, dims):
    rng = np.random.default_rng(32)
    prev = _data(rng, shape, dtype)
    ref = np.asarray(JOps.downsample_level(prev, factors, dims, dtype))
    got = TOps.downsample_level(torch.from_numpy(prev), factors, dims,
                                dtype).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == tuple(dims)
    if _exact(dtype, factors):
        np.testing.assert_array_equal(got, ref)
    elif dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_downsample_batch_is_per_box_block():
    """The batched program is the per-box one on each box (the JAX vmap)."""
    rng = np.random.default_rng(33)
    raws = _data(rng, (3, 16, 12, 8), "uint16")
    got = TOps.downsample_batch(torch.from_numpy(raws), (2, 2, 2)).numpy()
    ref = np.asarray(JD._make_downsample_kernel_cached(1, (2, 2, 2))(raws))
    np.testing.assert_array_equal(got, ref)
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(
            JOps.downsample_block(raws[b], (2, 2, 2))))


@pytest.mark.parametrize("value", [0.5, 1.5, 2.5, -0.5, 65535.5, 70000.0])
def test_convert_storage_rounds_half_to_even_like_jax(value):
    x = np.full((2, 2, 2), value, np.float32)
    for dt in ("uint8", "uint16", "float32"):
        ref = np.asarray(JOps.convert_storage(x, dt))
        got = TOps.convert_storage(torch.from_numpy(x), dt).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, JD._convert_to_dtype(x, dt))
        np.testing.assert_array_equal(TD._convert_to_dtype(x, dt),
                                      JD._convert_to_dtype(x, dt))


def test_read_padded_matches_jax():
    rng = np.random.default_rng(34)
    vol = _data(rng, (10, 9, 3), "uint16")

    def rd(off, size):
        return vol[tuple(slice(o, o + s) for o, s in zip(off, size))]

    for off, size in (((0, 0, 0), (4, 4, 4)), ((8, 6, 0), (4, 4, 8)),
                      ((2, 2, 2), (2, 2, 1))):
        np.testing.assert_array_equal(
            TD.read_padded(rd, vol.shape, off, size),
            JD.read_padded(rd, vol.shape, off, size))


@pytest.mark.parametrize("steps,ok", [
    ([[1, 1, 1], [2, 2, 1], [4, 4, 2]], True),
    ([[1, 1, 1], [2, 2, 1], [3, 3, 1]], False),
    ([[2, 2, 1], [4, 4, 2]], False),
])
def test_validate_pyramid_like_jax(steps, ok):
    for fn in (JD.validate_pyramid, TD.validate_pyramid):
        if ok:
            fn(steps)
        else:
            with pytest.raises(ValueError):
                fn(steps)
    block = create_grid((40, 40, 8), (16, 16, 8))[3]
    jblock = jgrid((40, 40, 8), (16, 16, 8))[3]
    assert TD.read_shape(block, (2, 2, 1)) == JD.read_shape(jblock, (2, 2, 1))


def test_pyramid_level_thin_axis_matches_jax(tmp_path):
    """A level dim clamped to 1 edge-replicates (tests/test_resave.py's
    thin case): the port's level writer gives the bytes of the JAX
    per-block writer."""
    src_vol = np.arange(64, dtype=np.uint16).reshape(8, 8, 1) * 7
    dims = [4, 4, 1]
    outs = []
    for mk, fmt in ((JStore, JFormat), (ChunkStore, StorageFormat)):
        store = mk.create(str(tmp_path / f"{mk.__module__}.n5"), fmt.N5)
        src = store.create_dataset("s0", (8, 8, 1), (8, 8, 1), "uint16")
        src.write(src_vol, (0, 0, 0))
        dst = store.create_dataset("s1", dims, (8, 8, 1), "uint16")
        if mk is JStore:
            for blk in jgrid(dims, dims):
                JD.downsample_write_block(src, dst, blk, (2, 2, 2))
        else:
            info = lambda ds, d, rel: MultiResolutionLevelInfo(
                ds, d, [8, 8, 1], rel, rel, "uint16")
            assert TD.downsample_pyramid_level(
                store, info("s0", [8, 8, 1], [1, 1, 1]),
                info("s1", dims, [2, 2, 2]), device="cpu") == 1
        outs.append(dst.read_full())
    np.testing.assert_array_equal(outs[1], outs[0])


def test_run_downsample_batches_by_shape(tmp_path):
    """Jobs of one source shape share K6 launches, at most four boxes each;
    edge blocks of another shape get their own; every block is written
    once, equal to the per-block program."""
    rng = np.random.default_rng(35)
    vol = _data(rng, (40, 24, 8), "uint16")
    grid = create_grid((20, 12, 4), (6, 6, 4))  # 4 x 2 blocks, 2 shapes
    written = {}

    def read_job(b):
        return TD.read_padded(
            lambda off, size: vol[tuple(slice(o, o + s)
                                        for o, s in zip(off, size))],
            vol.shape, [o * 2 for o in b.offset], [s * 2 for s in b.size])

    def write_job(b, data):
        assert b.offset not in written
        written[b.offset] = TD._convert_to_dtype(data, np.uint16)

    n = TD.run_downsample(grid, read_job, write_job, (2, 2, 2),
                          device="cpu", io_threads=3)
    assert n == 3  # 6 full blocks -> 4 + 2, 2 edge blocks -> 1
    assert len(written) == len(grid)
    for b in grid:
        ref = np.asarray(JOps.downsample_block(read_job(b), (2, 2, 2)))
        np.testing.assert_array_equal(written[b.offset],
                                      JD._convert_to_dtype(ref, np.uint16))
