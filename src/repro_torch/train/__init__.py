"""Training substrate (port of `repro.train`): AdamW, the schedule and
the train-step factory."""
