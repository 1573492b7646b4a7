"""Training of the port: the train/eval step (``harness``) and
initial-state tuning (``initial_state``)."""
