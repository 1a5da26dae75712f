"""The hybrid graph+vector plane.

Dense per-vertex embeddings as a store plane beside the triples, and a k-NN
operator that composes with basic graph patterns in both directions ("the
nearest neighbours of ?x that also satisfy this pattern"):

- :mod:`wukong_tpu_torch.vector.vstore` — the per-partition embedding store:
  a ``[n_slots, dim]`` float32 block keyed by vertex id with tombstoned
  upserts, riding the WAL (``maybe_wal_append("vector", ...)`` before the
  store mutates), the checkpoint bundles (store/persist.py) and the store
  version protocol (every vector mutation bumps the partition's version);
- :mod:`wukong_tpu_torch.vector.knn` — the k-NN operator: the NumPy scan on
  the host, or the hand-written ``csrc/knn_scan.cu`` kernel over the block
  staged on the card, with slice splitting across the engine pool for wide
  scans.

Everything is behind ``enable_vectors`` (default off).

The port's copy of the JAX package's vector/ package.
"""

from __future__ import annotations

#: every signal the vector plane emits, mapped to the registered metric
#: that backs it
VECTOR_METRICS = {
    "upserts": "wukong_vector_upserts_total",
    "tombstones": "wukong_vector_tombstones_total",
    "queries": "wukong_vector_queries_total",
    "routes": "wukong_vector_route_total",
    "route_demotions": "wukong_vector_route_demotions_total",
    "scan_latency": "wukong_vector_scan_us",
    "scan_slices": "wukong_vector_scan_slices_total",
}
