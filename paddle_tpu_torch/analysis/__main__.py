from paddle_tpu_torch.analysis.cli import main

raise SystemExit(main())
