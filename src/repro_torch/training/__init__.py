"""The train step, its state and the train loop (the reference's
``repro.training``)."""
