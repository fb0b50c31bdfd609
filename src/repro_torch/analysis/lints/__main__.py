"""``python -m repro_torch.analysis.lints [PATH...]``."""

import sys

from repro_torch.analysis.lints import main

if __name__ == "__main__":
    sys.exit(main())
