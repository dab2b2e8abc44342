"""The model zoo of the port (the transformer LM, the text LSTM and the
image models LeNet, SmallNet, ResNet, AlexNet and GoogLeNet, the
attention seq2seq NMT, DeepFM, the GAN, the VAE, the traffic
forecaster, the SRL tagger, the CRF chunker and the quick_start
classifiers so far)."""
