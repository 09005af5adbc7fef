"""Command-line interface.

Reference analog: cmd/ (cobra root, cmd/root.go:36-78) + ctl/ tools.
Subcommands: server, backup, restore, import, export, bench, check,
inspect, sort, config — invoked as ``python -m pilosa_tpu_torch.cli <cmd>``.
"""

from pilosa_tpu_torch.cli.main import main  # noqa: F401
