"""`python -m foamtpu_torch <command> -case <dir>` (port of
openfoam-2.2.x_tpu/__main__.py): the commands of apps/cli.py, `run`
among them. A case runs on the card unless `-device cpu` is given."""

import sys

from .apps.cli import main

if __name__ == "__main__":
    sys.exit(main())
