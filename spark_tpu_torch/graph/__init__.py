"""Graph processing — the GraphX/Pregel subset: the port of
``spark_tpu/graph`` (reference:
graphx/src/main/scala/org/apache/spark/graphx/Pregel.scala:59,
impl/GraphImpl.scala).

The reference iterates RDD joins per superstep (vertex-program /
sendMsg / mergeMsg as three shuffles per round). Here a graph is dense
tensors on a device (edges sorted by destination once), and a Pregel
run is a Python loop of supersteps, each a gather of the source state,
the edge message, a grouped merge by destination
(``physical/kernels.seg_sum``/``seg_min``/``seg_max`` over the sorted
ids; a float sum is ``seg_fsum`` on the card) and the vertex update. No
shuffles and no host sync inside the loop."""

from spark_tpu_torch.graph.pregel import Graph

__all__ = ["Graph"]
