"""The LM stack of the port: layers, KV caches, attention, the SSM and
the decoder stack."""
