"""Host-side data model: fragments, views, frames, indexes, holder, caches.

Reference analogs: fragment.go, view.go, frame.go, index.go, holder.go,
cache.go, attr.go, time.go.  This layer owns durability (snapshot + WAL),
the directory layout, and the metadata hierarchy; the compute-heavy query
path lives in pilosa_tpu_torch.ops (device kernels) and pilosa_tpu_torch.executor.
"""
