"""AdamW and learning-rate schedules (the reference's ``repro.optim``)."""
