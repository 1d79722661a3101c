import sys

from spgrid_torch.bench.cli import main

if __name__ == "__main__":
    sys.exit(main())
