"""Connect server, the Spark Connect / thriftserver analogue (the port of
``spark_tpu/connect/``; reference:
connector/connect/.../service/SparkConnectService.scala,
sql/hive-thriftserver/.../SparkExecuteStatementOperation.scala).

The wire is plain HTTP and Arrow IPC streams:

    POST /sql  {"query": "select ..."}  ->  Arrow IPC stream
    POST /plan {"plan": {...}}          ->  Arrow IPC stream
    GET  /tables                        ->  JSON list

Server: ``spark_tpu_torch.connect.serve(spark, port)``. Client:
``spark_tpu_torch.connect.Client("http://host:port").sql("...")`` ->
``pyarrow.Table``."""

from spark_tpu_torch.connect.server import Client, ConnectServer, serve

__all__ = ["ConnectServer", "Client", "serve"]
