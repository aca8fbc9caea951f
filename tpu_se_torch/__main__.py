import sys

from tpu_se_torch.cli.main import main

# Guarded: a spawned rank of a local mesh imports this module again.
if __name__ == "__main__":
    sys.exit(main())
