"""Model stack of the port: the config language, the dense layers and the
model assembly (train forward and loss)."""
