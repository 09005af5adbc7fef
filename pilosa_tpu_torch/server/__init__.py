"""HTTP API, client, and server composition.

Reference analogs: handler.go (route table + codecs), client.go (full
HTTP client), server.go (wiring + background loops).
"""

from pilosa_tpu_torch.server.handler import Handler  # noqa: F401
from pilosa_tpu_torch.server.server import Server  # noqa: F401
