"""Model substrate of the port: the paper's MLP and CNN."""
