"""Models of the port (PyTorch): layers, embeddings, the DLRM-UIH tenant."""
