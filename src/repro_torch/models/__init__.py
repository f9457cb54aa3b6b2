"""Models of the port: the dense decoder block and LM, the model API, and
ResNet-50."""
