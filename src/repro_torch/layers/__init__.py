"""Layers of the port: norms, rope, embeddings, gated MLP, GQA attention,
convolution and fully-connected layers."""
