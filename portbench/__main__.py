"""python3 -m portbench: one run of one cell (run.py)."""
import sys

from portbench.run import main

if __name__ == "__main__":
    sys.exit(main())
