"""Synthetic LM batches (the reference's ``repro.data``)."""
