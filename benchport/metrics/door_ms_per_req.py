"""door_ms_per_req: ms a request spends in the door (``server/`` and
``pql/``: admission, the query cache's lookup, the parse, the reply),
from the port's own spans (``trace.Tracer``, forced on every request of
the traced window): the root span less its executor children, averaged
over the window's traced requests."""

DOOR_CHILDREN = {"qos.admit", "qcache.lookup", "qcache.commit", "parse"}


def read(ctx):
    vals = []
    for t in ctx.port_spans:
        root = t["spans"]
        inner = sum(c.get("ms", 0.0) for c in root.get("children", [])
                    if c.get("name") not in DOOR_CHILDREN)
        vals.append(root["ms"] - inner)
    if not vals:
        return None
    return sum(vals) / len(vals)
