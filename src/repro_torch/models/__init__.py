"""Models of the port: the dense decoder block and LM, and the model API."""
