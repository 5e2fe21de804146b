"""``python -m lightgbm_tpu_torch``: the command line (``cli.py``)."""

import sys

if __name__ == "__main__":
    from .cli import main
    sys.exit(main())
