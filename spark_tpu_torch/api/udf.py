"""User-defined functions: the port of ``spark_tpu/api/udf.py``
(reference: sql/core/.../execution/python/ArrowEvalPythonExec.scala,
python/pyspark/sql/udf.py).

Two tiers, as in the reference:

- **tensor UDFs** (``@F.udf``, the reference's jax UDFs): the function
  takes torch tensors (one per argument, on the stage's device) and
  returns one. It runs inside the stage like a built-in expression, so a
  traced stage that holds it is captured into a CUDA graph with it on
  the card. It must not sync with the host: no ``.item()``, no
  ``.cpu()``, no tensor made from host data.
- **arrow UDFs** (``@F.arrow_udf``): the function takes and returns
  pyarrow arrays and runs on the host once per batch, for Python that
  cannot run on the device. An operator that holds one runs blocking,
  outside any traced stage (``E.contains_blocking``).

Nulls: a tensor UDF's result is NULL where any argument is NULL (Spark's
null-intolerant default); an arrow UDF sees NULL for NULL and dead rows
and returns its own nulls.
"""

from __future__ import annotations

from typing import Callable, Optional

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.types import DataType


def _factory(kind, fn: Optional[Callable], returnType: DataType):
    def wrap(f: Callable):
        def build(*cols):
            args = tuple(c if isinstance(c, E.Expression) else E.Col(c)
                         for c in cols)
            return kind(f, returnType, args, f.__name__)

        build.__name__ = f.__name__
        return build

    return wrap(fn) if fn is not None else wrap


def udf(fn: Optional[Callable] = None, returnType: DataType = T.FLOAT64):
    """Decorator or factory of tensor UDFs::

        @F.udf(returnType=T.FLOAT64)
        def hypot(x, y):            # torch tensors in, a tensor out
            return torch.sqrt(x * x + y * y)

        df.select(hypot("a", "b"))
    """
    return _factory(E.TensorUdf, fn, returnType)


def arrow_udf(fn: Optional[Callable] = None,
              returnType: DataType = T.FLOAT64):
    """Decorator or factory of host UDFs over pyarrow arrays."""
    return _factory(E.ArrowUdf, fn, returnType)
