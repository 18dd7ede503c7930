"""Serving and training steps of the LM stack: prefill and decode, the
chunked cross-entropy, the train step and the fault-tolerant trainer."""
