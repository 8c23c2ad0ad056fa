"""Pregel on dense device tensors: the port of
``spark_tpu/graph/pregel.py`` (reference: graphx/Pregel.scala:59
`apply` — initial msg, vprog/sendMsg/mergeMsg loop with active-set
tracking; PageRank.scala, ConnectedComponents.scala).

Messages merge per destination with the grouped reductions of
``physical/kernels.py`` over the destination ids, which are sorted once
at construction (the one-time analogue of GraphX's routing tables). A
superstep is a gather, the message, the merge and the update, all on the
graph's device; the supersteps are a Python loop (the reference's is one
``lax.fori_loop``). The one API difference: a ``pregel`` caller's
``message`` and ``update`` take and return torch tensors.

On the card PageRank's float32 merge is ``seg_fsum`` (each vertex's sum
exact, rounded once); on the CPU it is ``index_add_`` in edge order, as
the reference's ``segment_sum``, so the card's ranks differ from the
CPU's by the CPU's rounding only."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from spark_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_tpu_torch.physical import kernels as K

#: connected components checks for its fixpoint once per this many
#: supersteps (one host sync a block, as the reference)
CC_BLOCK = 8


class Graph:
    """Vertices are arbitrary int64 ids (sorted on the host once, the
    edges densified against them on the device); edges are (src, dst[,
    weight]). The tensors live on ``device`` (``"cuda"`` unless asked
    otherwise)."""

    def __init__(self, vertex_ids, edge_src, edge_dst, edge_attr=None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        dev = self.device
        vid = np.asarray(vertex_ids, dtype=np.int64)
        self.vertex_ids = np.sort(vid, kind="stable")
        if self.vertex_ids.size and (
                self.vertex_ids[1:] == self.vertex_ids[:-1]).any():
            dup = self.vertex_ids[1:][self.vertex_ids[1:]
                                      == self.vertex_ids[:-1]]
            raise ValueError(
                f"duplicate vertex ids: {np.unique(dup)[:5].tolist()}")
        self.n = int(vid.shape[0])
        # the edges' dense ids, checked and sorted on the device
        ids = torch.from_numpy(self.vertex_ids).to(dev)
        dense = []
        for vals, side in ((edge_src, "src"), (edge_dst, "dst")):
            v = torch.from_numpy(np.asarray(vals, dtype=np.int64)).to(dev)
            idx = torch.searchsorted(ids, v)
            if self.n:
                bad = (idx >= self.n) | (ids[idx.clamp_max(self.n - 1)] != v)
            else:
                bad = torch.ones_like(v, dtype=torch.bool)
            if bool(bad.any()):
                raise ValueError(
                    f"edge {side} references unknown vertex ids: "
                    f"{torch.unique(v[bad])[:5].tolist()}")
            dense.append(idx)
        # sort edges by destination ONCE: the message merge runs over
        # monotone ids (kernels.seg_* sorted path)
        eorder = torch.argsort(dense[1], stable=True)
        self.src = dense[0][eorder]
        self.dst = dense[1][eorder]
        self.edge_attr = (None if edge_attr is None else torch.from_numpy(
            np.ascontiguousarray(edge_attr)).to(dev)[eorder])
        self.m = int(self.src.shape[0])
        self.out_degree = torch.bincount(
            self.src, minlength=self.n).to(torch.int32)
        self.in_degree = torch.bincount(
            self.dst, minlength=self.n).to(torch.int32)

    # -- the core loop --------------------------------------------------------

    def pregel(self, init_state: torch.Tensor,
               message: Callable,
               update: Callable,
               num_iters: int,
               merge: str = "sum",
               default_msg=0.0):
        """Run ``num_iters`` supersteps:

            msgs      = message(src_state, edge_attr)      # (m,)
            merged[v] = merge(msgs to v)  or default_msg if none
            state     = update(state, merged)

        merge: 'sum' | 'min' | 'max'. ``message`` and ``update`` take and
        return torch tensors on the graph's device (reference peer:
        Pregel.scala:115's while loop of joins)."""
        red = {"sum": K.seg_sum, "min": K.seg_min, "max": K.seg_max}[merge]
        dst = self.dst.to(torch.int32)
        has_in = self.in_degree > 0
        m_mask = torch.ones((self.m,), dtype=torch.bool, device=self.device)
        state = init_state
        for _ in range(num_iters):
            msgs = message(state[self.src], self.edge_attr)
            merged = red(msgs, dst, m_mask, self.n, sorted_seg=True)
            merged = torch.where(
                has_in, merged,
                torch.full((), default_msg, dtype=merged.dtype,
                           device=self.device))
            state = update(state, merged)
        return state

    # -- library algorithms (reference: graphx/lib/) --------------------------

    def pagerank(self, num_iters: int = 20,
                 reset_prob: float = 0.15) -> torch.Tensor:
        """reference: graphx/lib/PageRank.scala `run` — contribution =
        rank/outDegree along each edge, rank = reset + (1-reset)*sum."""
        deg = torch.clamp_min(self.out_degree, 1).to(torch.float32)
        src_deg = deg[self.src]
        # the float32 constants, as the reference's weak-typed scalars
        keep = float(np.float32(1.0 - reset_prob))
        reset = float(np.float32(reset_prob))

        def message(src_rank, _):
            return src_rank / src_deg

        def update(rank, contrib):
            # XLA contracts the reference's update into one fused
            # multiply-add; here in float64, where the product of two
            # float32 values is exact, rounded to float32 (a double
            # rounding, which differs from the fma only in a halfway case)
            return (contrib.double() * keep + reset).to(torch.float32)

        init = torch.full((self.n,), 1.0, dtype=torch.float32,
                          device=self.device)
        return self.pregel(init, message, update, num_iters,
                           merge="sum", default_msg=0.0)

    def connected_components(self,
                             num_iters: Optional[int] = None) -> np.ndarray:
        """Min-label propagation over the UNDIRECTED graph (reference:
        graphx/lib/ConnectedComponents.scala). Returns, per vertex, the
        minimum original vertex id of its component."""
        both_src = torch.cat([self.src, self.dst])
        both_dst = torch.cat([self.dst, self.src])
        order = torch.argsort(both_dst, stable=True)
        src = both_src[order]
        dst = both_dst[order].to(torch.int32)
        m_mask = torch.ones((src.shape[0],), dtype=torch.bool,
                            device=self.device)
        has_in = torch.bincount(dst, minlength=self.n) > 0
        big = torch.full((), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=self.device)

        def step(labels):
            merged = K.seg_min(labels[src], dst, m_mask, self.n,
                               sorted_seg=True)
            return torch.minimum(labels, torch.where(has_in, merged, big))

        labels = torch.from_numpy(self.vertex_ids.copy()).to(self.device)
        if num_iters is not None:
            for _ in range(num_iters):
                labels = step(labels)
            return labels.cpu().numpy()
        # default: blocks of supersteps until a fixpoint (the reference
        # Pregel loop stops when no messages remain) — diameter-bound
        # instead of O(n) rounds
        for _ in range(0, max(2, self.n), CC_BLOCK):
            new_labels = labels
            for _ in range(CC_BLOCK):
                new_labels = step(new_labels)
            if torch.equal(new_labels, labels):
                break
            labels = new_labels
        return labels.cpu().numpy()

    def triangle_count(self) -> int:
        """Total triangles via the dense adjacency: trace(A^3)/6 over the
        undirected simple graph, A float32 and ``A @ A @ A`` in float32
        (TF32 off, torch's default), for graphs small enough to densify
        (reference: graphx/lib/TriangleCount.scala counts via
        neighbor-set intersection). Every entry of the products is a
        count of walks, exact while below 2^24; the trace is summed in
        float64."""
        a = torch.zeros((self.n, self.n), dtype=torch.float32,
                        device=self.device)
        a[self.src, self.dst] = 1.0
        a[self.dst, self.src] = 1.0
        a.fill_diagonal_(0.0)
        a3 = a @ a @ a
        return int(torch.diagonal(a3).sum(dtype=torch.float64) / 6.0)
