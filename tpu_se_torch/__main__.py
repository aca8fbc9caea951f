import sys

from tpu_se_torch.cli.main import main

sys.exit(main())
