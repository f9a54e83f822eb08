"""``python -m epik_tpu`` entry point (the reference's ``epik.py`` surface)."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
