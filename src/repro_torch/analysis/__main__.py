# Port of src/repro/analysis/__main__.py.
"""``python -m repro_torch.analysis`` == the ``repro-torch-lint`` console
script."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
