import sys

from tetraear_tpu_torch.ui.cli import main

if __name__ == "__main__":
    sys.exit(main())
