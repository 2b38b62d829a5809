"""``python -m repro_torch.store`` -> the store CLI."""

import sys

from .cli import main

sys.exit(main())
