"""The LM stack of the dense family: parameters, layers, the decoder and its registry."""
