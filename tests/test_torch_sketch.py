"""The port's sketches (``spark_tpu_torch/sketch.py``) and the exchange
stats stage that sketches a mesh exchange's keys
(``parallel/operators.ExchangeStatsExec``) against the reference's
(``spark_tpu/sketch.py``, ``spark_tpu/parallel/operators.py``) on the
same numpy-seeded keys, on the CPU.

- HyperLogLog registers, Count-Min tables and estimates, Bloom filter
  bits and memberships equal the reference's exactly, merges included.
- The stats stage's columns at 8 ranks equal the reference's at 8
  devices: routing counts, the 512 HLL registers, per-key min/max/NULL
  counts and the Count-Min candidates (hash and estimate per rank). The
  port takes the HLL rank through the reference's float64 log2, so
  registers agree everywhere, the reference's documented mis-rank by one
  near a power of two included.
- The accuracy properties the reference's suite pins (never an
  under-count, the 2N/width over-count bound, HLL within 4 sigma).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import spark_tpu.expr.expressions as RE
import spark_tpu.parallel.operators as RD
import spark_tpu.sketch as ref_sketch
import spark_tpu_torch.expr.expressions as E
import spark_tpu_torch.parallel.operators as D
from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu.parallel.executor import MeshExecutor as RefMeshExecutor
from spark_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_tpu.parallel.sharded import ShardedBatch as RefShardedBatch
from spark_tpu_torch import sketch
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.parallel.executor import MeshExecutor
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.parallel.sharded import ShardedBatch

from test_torch_threads import one_torch_thread  # noqa: F401


def _keys(seed, n=20000):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.4, 7,
                    rng.integers(-(1 << 40), 1 << 40, n)).astype(np.int64)


# ---- the host and device sketch classes --------------------------------------


@pytest.mark.parametrize("registers", [16, 512, 4096])
def test_hyperloglog_registers_equal_reference(registers):
    vals = _keys(registers)
    a, b = sketch.HyperLogLog(registers), ref_sketch.HyperLogLog(registers)
    for chunk in np.array_split(vals, 3):
        a.update(chunk)
        b.update(chunk)
    np.testing.assert_array_equal(a.registers, b.registers)
    other = sketch.HyperLogLog(registers)
    other.update(vals[::7] * 3)
    ref_other = ref_sketch.HyperLogLog(registers)
    ref_other.update(vals[::7] * 3)
    np.testing.assert_array_equal(a.merge(other).registers,
                                  b.merge(ref_other).registers)
    assert a.estimate() == b.estimate()


@pytest.mark.parametrize("true_ndv", [64, 3000])
def test_hyperloglog_host_class_accuracy(true_ndv):
    """Chunked updates and a merge against exact distinct counts (the
    hybrid join's partition oracle uses the same path)."""
    rng = np.random.default_rng(true_ndv)
    vals = rng.choice(1 << 40, true_ndv, replace=False).astype(np.int64)
    a, b = sketch.HyperLogLog(512), sketch.HyperLogLog(512)
    a.update(vals[: true_ndv // 2])
    b.update(vals[true_ndv // 3:])          # overlapping chunks
    est = a.merge(b).estimate()
    assert abs(est - true_ndv) <= max(8, 4 * 1.04 / np.sqrt(512) * true_ndv)


@pytest.mark.parametrize("depth,width", [(4, 64), (5, 256), (7, 2048)])
def test_countmin_table_equals_reference(depth, width):
    vals = _keys(depth * width)
    mask = np.random.default_rng(1).random(vals.size) < 0.8
    cm = sketch.CountMinSketch(depth, width, device="cpu").add(vals, mask)
    ref = ref_sketch.CountMinSketch(depth, width).add(jnp.asarray(vals),
                                                      jnp.asarray(mask))
    np.testing.assert_array_equal(cm.table.numpy(), np.asarray(ref.table))
    for v in (7, int(vals[3]), 12345):
        assert cm.estimate(v) == ref.estimate(v)
    more = sketch.CountMinSketch(depth, width, device="cpu").add(vals[::5])
    ref_more = ref_sketch.CountMinSketch(depth, width).add(
        jnp.asarray(vals[::5]))
    np.testing.assert_array_equal(cm.merge(more).table.numpy(),
                                  np.asarray(ref.merge(ref_more).table))


@pytest.mark.parametrize("width", [64, 256])
def test_countmin_never_undercounts_small_widths(width):
    """Never an under-count, and at small widths the over-count within
    the classic 2N/width bound (x4 slack on the skewed stream)."""
    rng = np.random.default_rng(width)
    n, k = 20000, 500
    keys = np.where(rng.random(n) < 0.4, 7,
                    rng.integers(0, k, n)).astype(np.int64)
    cm = sketch.CountMinSketch(depth=4, width=width, device="cpu").add(keys)
    uniq, counts = np.unique(keys, return_counts=True)
    for v, c in zip(uniq[:64], counts[:64]):
        est = cm.estimate(int(v))
        assert int(c) <= est <= int(c) + 4 * (2 * n // width), (v, est, c)
    assert int(uniq[np.argmax(counts)]) == 7
    assert cm.estimate(7) >= int(counts.max())


def test_countmin_for_rsd_sizes_like_reference():
    cm = sketch.CountMinSketch.for_rsd(0.01, 0.99, device="cpu")
    ref = ref_sketch.CountMinSketch.for_rsd(0.01, 0.99)
    assert (cm.depth, cm.width) == (ref.depth, ref.width)


@pytest.mark.parametrize("bits,hashes", [(1 << 10, 3), (1 << 16, 5)])
def test_bloom_filter_bits_equal_reference(bits, hashes):
    vals = _keys(bits)[:5000]
    mask = np.random.default_rng(2).random(vals.size) < 0.7
    bf = sketch.BloomFilter(bits, hashes, device="cpu").add(vals, mask)
    ref = ref_sketch.BloomFilter(bits, hashes).add(jnp.asarray(vals),
                                                   jnp.asarray(mask))
    np.testing.assert_array_equal(bf.bits.numpy(), np.asarray(ref.bits))
    probe = np.concatenate([vals[:500], _keys(99)[:500] + 3])
    got = bf.might_contain(probe).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        ref.might_contain(jnp.asarray(probe))))
    assert got[:500][mask[:500]].all()  # no false negative
    other = sketch.BloomFilter(bits, hashes, device="cpu").add(probe)
    ref_other = ref_sketch.BloomFilter(bits, hashes).add(jnp.asarray(probe))
    np.testing.assert_array_equal(bf.merge(other).bits.numpy(),
                                  np.asarray(ref.merge(ref_other).bits))


def test_bloom_filter_for_items_sizes_like_reference():
    bf = sketch.BloomFilter.for_items(10_000, 0.03, device="cpu")
    ref = ref_sketch.BloomFilter.for_items(10_000, 0.03)
    assert (bf.num_bits, bf.num_hashes) == (ref.num_bits, ref.num_hashes)


def test_sketches_raise_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sketch.CountMinSketch()
    with pytest.raises(RuntimeError, match="cuda"):
        sketch.BloomFilter()


# ---- the exchange stats stage -----------------------------------------------


def _stats_table(seed, n=40000):
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.3, 7, rng.integers(0, 1 << 40, n))
    kmask = rng.random(n) < 0.05
    words = np.array([f"w{i}" for i in range(300)])[rng.integers(0, 300, n)]
    return pa.table({
        "k": pa.array(k.astype(np.int64), pa.int64(), mask=kmask),
        "s": pa.array(list(words), pa.string()),
        "v": pa.array(rng.integers(0, 100, n), pa.int64())})


def _ref_stats(table, keys, **kw):
    mesh = ref_make_mesh(8)
    sb = RefShardedBatch.from_batch(ref_from_arrow(table), mesh)
    ex = RD.HashPartitionExchangeExec(tuple(RE.Col(k) for k in keys),
                                      RD.ShardScanExec(sb))
    out = RefMeshExecutor(mesh)._run_stage(RD.ExchangeStatsExec(ex, **kw))
    cap = max(8, kw.get("sketch_registers", 0), kw.get("key_stats", 0))
    return {f.name: np.asarray(c.data)[:cap].astype(np.int64)
            for f, c in zip(out.schema.fields, out.data.columns)}


def _port_stats(table, keys, **kw):
    mesh = make_mesh(8, devices=["cpu"] * 8)
    sb = ShardedBatch.from_batch(from_arrow(table, device="cpu"), mesh)
    ex = D.HashPartitionExchangeExec(tuple(E.Col(k) for k in keys),
                                     D.ShardScanExec(sb))
    out = MeshExecutor(mesh)._run_stage(D.ExchangeStatsExec(ex, **kw))
    return {f.name: c.data.numpy() for f, c in
            zip(out.schema.fields, out.shards[0].columns)}


@pytest.mark.parametrize("keys", [("k",), ("k", "s")])
def test_exchange_stats_equal_reference(keys):
    """Every column of the extended stats stage at 8 ranks (512 HLL
    registers through kernels.seg_max, a 4 x 1024 Count-Min through
    kernels.seg_count) equals the reference's at 8 devices."""
    table = _stats_table(len(keys))
    kw = dict(sketch_registers=512, key_stats=len(keys), cm_depth=4,
              cm_width=1024)
    got, want = _port_stats(table, keys, **kw), _ref_stats(table, keys, **kw)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["__incoming"][:8].sum() == table.num_rows
    assert (got["__ndvreg"] > 0).all()
    if keys == ("k",):  # about 28% of the rows share k = 7: every
        # rank's candidate is that key
        assert (got["__hotest"][:8] >= 0.25 * table.num_rows).all()


def test_exchange_stats_routing_only_equals_reference():
    table = _stats_table(3, n=5000)
    got, want = _port_stats(table, ("s",)), _ref_stats(table, ("s",))
    assert list(got) == ["__incoming", "__maxslice"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_hll_registers_take_the_reference_float_rank():
    """The HLL rank is the reference's float64 floor(log2) of the
    64 - p bit hash suffix, so a suffix just under a power of two (here
    2^54 - 1, which float64 rounds up to 2^54) ranks as the reference
    ranks it: one lower than its exact leading-zero count."""
    from spark_tpu_torch.parallel import exchange as X
    from spark_tpu_torch.physical import kernels as K

    p = 9
    w = torch.tensor([(1 << 54) - 1, 1 << 54, 1, 0], dtype=torch.int64)
    h = (w << p) | 5
    got = torch.floor(torch.log2(K.shift_right_logical(h, p)
                                 .to(torch.float64).clamp(min=1.0)))
    ref = jnp.floor(jnp.log2(jnp.maximum(
        (jnp.asarray(np.asarray(h.numpy()).view(np.uint64))
         >> jnp.uint64(p)).astype(jnp.float64), 1.0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == 54 and 64 - p - int(got[0]) == 1  # exact rank is 2
    assert X is not None
