from spark_tpu_torch.tpch.gen import (  # noqa: F401
    dataset_report, ensure_dataset, generate_tables, register_views,
    write_parquet, write_parquet_streamed)
from spark_tpu_torch.tpch.queries import Q1_WIDE, QUERIES  # noqa: F401
