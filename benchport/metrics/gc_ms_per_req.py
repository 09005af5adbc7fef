"""gc_ms_per_req: ms a request is paused in Python's collector, from the
port's tracer: the root's ``gc_ms`` tag (pauses on the request's thread
while it was open; 0 where the root has none), averaged over the
window's traced requests.  None where no root carries ``t0_ns``: a
tracer without the absolute clock has no collector tags either."""


def read(ctx):
    roots = [t["spans"] for t in ctx.port_spans]
    if not any("t0_ns" in r for r in roots):
        return None
    return sum(r.get("tags", {}).get("gc_ms", 0.0) for r in roots) / len(roots)
