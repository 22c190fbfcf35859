"""green_marl_tpu — graph-analytics framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
libshoal/Green-Marl (see SURVEY.md at the repo root): an immutable padded
CSR graph substrate, a segment-reduction/edge-map kernel library, a jitted
superstep engine, mesh-sharded multi-device execution, and the reference's
algorithm suite (PageRank, BFS/hop_dist, SSSP, CC, triangle counting,
conductance, betweenness centrality, ...).
"""

from .graph.csr import Graph, GraphBuilder, from_edges  # noqa: F401

__version__ = "0.1.0"
