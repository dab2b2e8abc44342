"""The model zoo of the port (the transformer LM, the text LSTM and the
image models LeNet, SmallNet, ResNet, AlexNet and GoogLeNet, the
attention seq2seq NMT, DeepFM, the GAN, the VAE and the traffic
forecaster so far)."""
