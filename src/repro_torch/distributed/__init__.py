"""Gradient compression (the part of the reference's
``repro.distributed`` that the train step uses)."""
