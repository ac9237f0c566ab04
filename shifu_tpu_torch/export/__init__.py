"""Model export — the port of ``shifu_tpu.export``: PMML documents
(:mod:`.pmml`) and the reference's own serialized model formats
(:mod:`.reference_spec`)."""
