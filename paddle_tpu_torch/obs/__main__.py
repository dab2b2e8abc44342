import sys

from paddle_tpu_torch.obs.cli import main

sys.exit(main())
