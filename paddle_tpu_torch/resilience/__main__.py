import sys

from paddle_tpu_torch.resilience.cli import main

sys.exit(main())
