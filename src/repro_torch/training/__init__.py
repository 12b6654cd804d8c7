"""Training on one device: AdamW, the synthetic token stream, the train
step, int8 gradient compression and checkpoints (port of
``repro.training``)."""
