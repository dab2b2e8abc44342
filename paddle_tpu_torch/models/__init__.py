"""The model zoo of the port (the transformer LM so far)."""
