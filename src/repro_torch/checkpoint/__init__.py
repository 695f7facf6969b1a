"""Checkpoints of the train state (the reference's ``repro.checkpoint``)."""
