"""Tensor-parallel serving's mesh rules, collectives and context
(``sharding``, ``collectives``, ``autoshard``), gradient compression and
the fault-tolerance units (the parts of the reference's
``repro.distributed`` that training uses)."""
