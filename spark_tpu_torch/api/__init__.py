from spark_tpu_torch.api.session import SparkSession  # noqa: F401
