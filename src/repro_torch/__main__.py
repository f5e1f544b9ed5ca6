"""Entry point: ``python -m repro_torch <subcommand>`` (see
``repro_torch.cli``)."""
import sys

from repro_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
