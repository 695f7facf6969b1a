"""The train step and its state (the reference's ``repro.training``)."""
