"""Fault injection and supervision for the serving and rollout runtime."""
