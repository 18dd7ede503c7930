"""Serving steps of the LM stack."""
