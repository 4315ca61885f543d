"""Training substrate of the port: the guarded, checkpointing loop."""
