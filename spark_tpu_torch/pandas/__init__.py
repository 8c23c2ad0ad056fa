"""pandas-on-spark subset (reference: python/pyspark/pandas/ — the
pandas API executed by the SQL engine).

The port of ``spark_tpu/pandas``. A thin, lazy layer: a ``PsFrame``
wraps an engine DataFrame; indexing, arithmetic, boolean filtering,
groupby aggregation and merge translate to logical-plan builders and
execute on the session's device (one device or a mesh) only at
materialization points (``to_pandas``, ``len``, ``head``).

    import spark_tpu_torch.pandas as ps
    pdf = ps.read_parquet("lineitem.parquet")
    out = pdf[pdf.l_quantity > 10].groupby("l_returnflag").agg(
        {"l_extendedprice": "sum"})
    out.to_pandas()
"""

from spark_tpu_torch.pandas.frame import (PsFrame, concat, from_pandas,
                                          read_parquet)

__all__ = ["PsFrame", "from_pandas", "read_parquet"]
