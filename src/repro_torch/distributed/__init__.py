"""Gradient compression and the fault-tolerance units (the parts of the
reference's ``repro.distributed`` that training uses)."""
