"""launch_gap_ms_per_req: host ms a request spends inside its launch
spans while their kernels are not running, from the port's launch
spans: each ``device`` span's ``ms`` (host time from the call until the
counts are on the host) less its ``device_ms`` (its kernels' time, each
between two CUDA events recorded at the kernel's own launch), summed a
request and averaged over the window's traced requests: the dispatch
gate, the id staging and upload, the launch calls, the sync and the
fetch.  None where no span carries ``device_ms`` (the CPU engine, or a
program without it)."""


def _gaps(span, out) -> None:
    for c in span.get("children", []):
        dev = c.get("tags", {}).get("device_ms") if c.get("name") == "device" else None
        if dev is not None:
            out.append(c.get("ms", 0.0) - dev)
        _gaps(c, out)


def read(ctx):
    vals, seen = [], False
    for t in ctx.port_spans:
        gaps: list = []
        _gaps(t["spans"], gaps)
        seen = seen or bool(gaps)
        vals.append(sum(gaps))
    if not seen:
        return None
    return sum(vals) / len(vals)
