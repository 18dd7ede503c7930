"""Token data pipelines of the LM stack's training path."""
