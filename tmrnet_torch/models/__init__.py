"""TMRNet modules: ResNet backbone, LSTM, TimeConv/NLBlock head, BN folding
and the weight bridge from the JAX package's variables."""
