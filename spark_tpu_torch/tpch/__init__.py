from spark_tpu_torch.tpch.gen import generate_tables, register_views  # noqa: F401
from spark_tpu_torch.tpch.queries import Q1_WIDE, QUERIES  # noqa: F401
