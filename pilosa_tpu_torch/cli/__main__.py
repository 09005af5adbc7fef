"""`python -m pilosa_tpu_torch.cli` entry point."""

import sys

from pilosa_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
