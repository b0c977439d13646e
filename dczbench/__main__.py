"""``python -m dczbench``: see :mod:`dczbench.run`."""

import sys

from dczbench.run import main

sys.exit(main())
