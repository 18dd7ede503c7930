"""Sharding of the LM stack on a slot mesh: the logical-axis rules and the
placement of tensors as blocks on the mesh's slots."""
