"""The model zoo of the port (the transformer LM and the text LSTM so
far)."""
