"""spark_tpu_torch: the PyTorch/CUDA port of spark_tpu.

Runs the SQL engine's single-device main path (SQL text -> parser ->
logical plan -> optimizer -> physical plan -> masked columnar operators ->
rows) with torch tensors. The grouped-aggregation kernels are hand-written
CUDA (``ops/csrc/seg_agg.cu``); everything else is plain torch, run
eagerly. Entry point: ``spark_tpu_torch.api.session.SparkSession``.
"""

from spark_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
