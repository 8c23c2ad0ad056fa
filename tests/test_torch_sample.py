"""The port's sampler stream (``spark_tpu_torch/physical/random.py``)
against JAX's: ``uniform(seed, n)`` equals ``jax.random.uniform(
jax.random.PRNGKey(seed), (n,))`` in float64 (the reference's draw, x64
on) bit for bit, for several seeds and capacities; and ``SampleExec``'s
rows equal the reference's ``df.sample`` rows on the same table."""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.api import functions as RF
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.physical.random import random_bits64, uniform

from test_torch_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 7, 42, 2 ** 31 + 11, 2 ** 40 + 5, -3)
SIZES = (1, 1000, 1024, 65_537)


def test_jax_is_the_stream_the_port_copies():
    """The JAX configuration the port's stream was written against: the
    threefry2x32 implementation with partitionable bits, x64 on."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert jax.random.uniform(jax.random.PRNGKey(0), (1,)).dtype \
        == np.float64


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax_bit_for_bit(seed, n):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
    got = uniform(seed, n, "cpu").numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("seed", (0, 7, 2 ** 40 + 5))
def test_random_bits_equal_jax(seed):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (4096,),
                                      np.uint64))
    got = random_bits64(seed, 4096, "cpu").numpy().view(np.uint64)
    assert np.array_equal(got, want)


def test_first_draws_of_seed_7():
    """The values the sample of ``seed=7`` starts from."""
    got = uniform(7, 2, "cpu")
    assert got.tolist() == pytest.approx([0.84410695, 0.04541259],
                                         abs=1e-8)


def test_uniform_lies_in_the_unit_interval():
    u = uniform(99, 100_000, "cpu")
    assert bool((u >= 0).all()) and bool((u < 1).all())
    assert abs(float(u.mean()) - 0.5) < 0.01


@pytest.fixture(scope="module")
def engines(spark):
    return {"ref": (spark, RF), "port": (PortSession(device="cpu"), PF)}


def _table(n: int):
    rng = np.random.default_rng(5)
    return pa.table({"k": pa.array(np.arange(n), pa.int64()),
                     "g": pa.array(rng.integers(0, 5, n), pa.int64()),
                     "s": pa.array([f"s{i % 7}" for i in range(n)])})


@pytest.mark.parametrize("n,fraction,seed", [
    (100, 0.5, 7), (3000, 0.01, 7), (3000, 0.3, 123), (5000, 0.9, 0)])
def test_sample_rows_equal_reference(engines, n, fraction, seed):
    """``df.sample(fraction, seed)`` keeps the reference's rows, and an
    aggregate over the sample equals the reference's."""
    out = {}
    for name, (s, F) in engines.items():
        df = s.createDataFrame(_table(n)).sample(fraction, seed=seed)
        rows = sorted(tuple(r) for r in df.collect())
        agg = [tuple(r) for r in df.groupBy("g").agg(
            F.count("*").alias("n"), F.sum("k").alias("sk"))
            .orderBy("g").collect()]
        out[name] = (rows, agg)
    assert out["port"] == out["ref"]
    kept = len(out["port"][0])
    # a binomial bound as a sanity check on the rows themselves
    sd = (n * fraction * (1 - fraction)) ** 0.5
    assert abs(kept - n * fraction) <= 5 * sd + 1


def test_sample_sql_after_filter_equals_reference(engines):
    """The stream is drawn over the capacity that reaches the sampler:
    a filter below it keeps the capacity, so the rows stay the
    reference's."""
    out = {}
    for name, (s, F) in engines.items():
        df = s.createDataFrame(_table(2048)).filter(F.col("g") != 3) \
            .sample(0.25, seed=11)
        out[name] = sorted(tuple(r) for r in df.collect())
    assert out["port"] == out["ref"]
