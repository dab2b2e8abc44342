"""The model zoo of the port (the transformer LM, the text LSTM and the
image models LeNet, SmallNet, ResNet, AlexNet and GoogLeNet, and the
attention seq2seq NMT so far)."""
