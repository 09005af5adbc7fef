"""read_ratio: bytes the launches read over the bytes the requests
need, from the port's spans: the ``device`` spans' ``bytes_read`` (each
launch's distinct rows x slices x 131,072 B) over the ``fused`` spans'
``need_bytes`` (each request's distinct rows x slices x 131,072 B),
summed over the window's traced requests.  1 where every row is read
by one launch of its request, as where one launch folds all of a
resident part's N-ary groups; above 1 where launches that share rows
read them again (pair and tree groups, each launched alone).  A group
that the staged gate launches alone is counted in its part's one
``device`` span, so the ratio errs low where it shares rows with the
rest.  None where no ``fused`` span carries ``need_bytes`` (a program
without it)."""


def _sums(span, acc) -> None:
    tags = span.get("tags", {})
    if span.get("name") == "device":
        acc[0] += tags.get("bytes_read", 0)
    elif span.get("name") == "fused":
        acc[1] += tags.get("need_bytes", 0)
    for c in span.get("children", []):
        _sums(c, acc)


def read(ctx):
    acc = [0, 0]
    for t in ctx.port_spans:
        _sums(t["spans"], acc)
    if acc[1] <= 0:
        return None
    return acc[0] / acc[1]
