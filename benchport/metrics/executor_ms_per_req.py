"""executor_ms_per_req: ms a request spends in the executor's own host
work, from the port's spans (``trace.Tracer``, forced on every request
of the traced window): the root's children that ``door_ms_per_req``
does not count as door (``flat``, ``fused``, ``call.*``), less the
``device`` (launch) spans beneath them, averaged over the window's
traced requests.  Door + this + every ``device`` span's ``ms`` is the
root's ``ms``."""

# The door's children, as ``door_ms_per_req.py`` counts them.
DOOR_CHILDREN = {"qos.admit", "qcache.lookup", "qcache.commit", "parse"}


def _device_ms(span) -> float:
    return sum(c.get("ms", 0.0) if c.get("name") == "device" else _device_ms(c)
               for c in span.get("children", []))


def read(ctx):
    vals = []
    for t in ctx.port_spans:
        ms = 0.0
        for c in t["spans"].get("children", []):
            if c.get("name") not in DOOR_CHILDREN and c.get("name") != "device":
                ms += c.get("ms", 0.0) - _device_ms(c)
        vals.append(ms)
    if not vals:
        return None
    return sum(vals) / len(vals)
