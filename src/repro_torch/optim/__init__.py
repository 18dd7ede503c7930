"""Optimizer and gradient compression of the LM stack's training path."""
