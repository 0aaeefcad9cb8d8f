"""Model substrate of the port: the paper's MLP and CNN, and the dense
LLM stack (layers, rope, attention, blocks, frontends, model)."""
