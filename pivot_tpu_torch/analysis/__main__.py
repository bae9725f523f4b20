"""``python -m pivot_tpu_torch.analysis`` — the graftcheck CLI of the
port (counterpart of ``pivot_tpu/analysis/__main__.py``)."""

import sys

from pivot_tpu_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
