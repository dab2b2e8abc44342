"""paddle_tpu_torch.master — the lease table the serving fleet runs on
(:mod:`~paddle_tpu_torch.master.service`)."""
