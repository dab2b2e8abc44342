"""Measurement scripts of the port, run on the card from the repo root
(``python -m paddle_tpu_torch.tools.<name>``)."""
