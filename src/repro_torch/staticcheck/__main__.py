"""``python -m repro_torch.staticcheck`` entry point."""

import sys

import repro_torch.staticcheck  # noqa: F401  (registers every rule)
from repro_torch.staticcheck.cli import main

if __name__ == "__main__":
    sys.exit(main())
