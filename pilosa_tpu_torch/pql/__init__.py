"""PQL: the Pilosa Query Language.

Reference analog: pql/ (scanner.go, parser.go, ast.go, token.go).  Queries
are whitespace-separated call trees like::

    Count(Intersect(Bitmap(rowID=10, frame="stargazer"),
                    Bitmap(rowID=5, frame="language")))
    SetBit(rowID=1, frame="f", columnID=100)
    TopN(frame="f", n=20, field="category", filters=[1, 2])
    Range(rowID=1, frame="f", start="2017-01-01T00:00", end="2017-02-01T00:00")
"""

from pilosa_tpu_torch.pql.ast import Call, Query, TIME_FORMAT  # noqa: F401
from pilosa_tpu_torch.pql.parser import ParseError, parse, parse_cached  # noqa: F401
