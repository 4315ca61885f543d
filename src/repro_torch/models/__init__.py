"""Models of the port: the dense decoder-only transformer and the ColPali
encoder over it."""
