"""``python -m repro_torch.analysis`` — run the port's contract linter."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
