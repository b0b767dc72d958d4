"""``python -m zen_tpu_torch``: the zen-torch CLI (``cli.py``)."""
import sys

from .cli import main

sys.exit(main())
