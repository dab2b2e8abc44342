import sys

from paddle_tpu_torch.cli import main

sys.exit(main())
