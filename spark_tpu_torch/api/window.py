"""Window specifications, the ``pyspark.sql.window`` surface (the port of
``spark_tpu/api/window.py``; reference: sql/core/.../expressions/
Window.scala).

    from spark_tpu_torch.api.window import Window
    w = Window.partitionBy("dept").orderBy(F.desc("salary"))
    df.withColumn("rk", F.rank().over(w))
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

from spark_tpu_torch.expr import expressions as E


def _c(x):
    return x if isinstance(x, E.Expression) else E.Col(x)


def _order(x) -> E.SortOrder:
    e = _c(x)
    return e if isinstance(e, E.SortOrder) else E.SortOrder(e, True)


class WindowSpec:
    def __init__(self, partition_by: Tuple[E.Expression, ...] = (),
                 order_by: Tuple[E.SortOrder, ...] = (),
                 frame: Optional[tuple] = None):
        self._partition_by = partition_by
        self._order_by = order_by
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowSpec":
        return WindowSpec(tuple(_c(c) for c in cols), self._order_by,
                          self._frame)

    def orderBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self._partition_by,
                          tuple(_order(c) for c in cols), self._frame)

    def _between(self, mode: str, start: int, end: int) -> "WindowSpec":
        s = None if start <= Window.unboundedPreceding else start
        e = None if end >= Window.unboundedFollowing else end
        return WindowSpec(self._partition_by, self._order_by, (mode, s, e))

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return self._between("rows", start, end)

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        return self._between("range", start, end)

    def _attach(self, func: E.Expression) -> E.WindowExpr:
        return E.WindowExpr(func, self._partition_by, self._order_by,
                            self._frame)


class Window:
    unboundedPreceding = -(sys.maxsize - 1)
    unboundedFollowing = sys.maxsize - 1
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rowsBetween(start, end)
